"""Global constants (a copy of ``metaasr_tpu/constants.py``).

The reference keeps these in a constants module (R: src/marcos.py, SURVEY.md
section 2.1 #2): blank id, pad id, special token ids, feature dim.
"""

# CTC blank symbol. Kaldi/ESPnet convention: blank = 0.
BLANK_ID = 0

# Padding id for token sequences. Shares id 0 with blank on the CTC side;
# attention-decoder targets use IGNORE_ID in the loss mask instead.
PAD_ID = 0

# Attention decoder special tokens (appended after the subword vocab).
SOS_EOS_OFFSET = 1  # <sos>/<eos> share one id, placed at vocab_size - 1.

# Label positions to ignore in the attention loss.
IGNORE_ID = -1

# Log-mel feature dimension (80-dim fbank, SURVEY.md section 2.1 #16).
FEAT_DIM = 80

# Audio front-end defaults (Kaldi-compliance, SURVEY.md section 2.1 #16).
SAMPLE_RATE = 16000
FRAME_LENGTH_MS = 25.0
FRAME_SHIFT_MS = 10.0
PREEMPHASIS = 0.97
N_FFT = 512
MEL_LOW_FREQ = 20.0
MEL_HIGH_FREQ = 0.0  # 0.0 -> Nyquist

# Numerical floors.
LOG_EPS = -1e30  # "minus infinity" for log-space recursions (fp32-safe)
