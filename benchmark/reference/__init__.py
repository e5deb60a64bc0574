"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy, written from the published description of each
model (the joint CTC-attention transformer of Hsu, Chen & Lee, ICASSP 2020;
the VGG-BLSTM CTC recognizer) and of the Kaldi front-end. It imports
nothing of the program and takes nothing the program made: the benchmark
hands both sides the same weights and inputs, and the reference works out
everything else again.

Randomness: a seeded training step draws its SpecAugment masks and dropout
masks from ``torch.Generator`` objects seeded by ``fold_in`` of the step's
seed, one generator per consumer, in a fixed order (``seeds.py``). The
reference makes the same draws in the same order, so both sides mask the
same frames and units and the comparison sees arithmetic alone.

Every product runs in the precision named by a ``numerics.Precision``:
``fp32`` (TF32 off) for the reference itself, ``bf16`` or ``fp8`` (each
operand of a matrix product or convolution rounded to that type) for the
controls that must fail the comparison.
"""
