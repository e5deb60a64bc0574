"""Each hand-written kernel's least time on the card from its launch shape:
the larger of its operations over the peak rate they run at and its bytes
(each input read once, each output written once) over HBM's bandwidth.

- K1, the fused log-mel filterbank ([B, S] waveforms -> [B, F, M]): the
  samples of the valid frames, the frame lengths, its read-only tables
  (twiddles, window, mel ranges and weights: ``K1_TABLE_BYTES``) and the
  features; ``K1_FP64_OPS`` fp64 operations a valid frame (front-end
  2,000, the FFT's three passes, the real split and the power) at the fp64
  tensor-core rate, against 2 fp32 operations per mel weight and per bin.
- K2, the CTC forward-backward on [B, T, S] extended-label emissions: 16
  operations an element (10 flops, 6 transcendentals) at the fp32 rate;
  the emissions read and their gradient written, the skip mask and three
  per-row values.
- K3 (LSTM recurrence forward) and K3b (its backward from the saved gates,
  with the dU product) at [T, B, H]: 2 T B H 4H and 4 T B H 4H fp32
  operations; forward reads the input gates and U, writes h, c and the
  gates; backward reads gates, h, c and the output gradient and writes the
  input-gate gradient and dU.
"""

from __future__ import annotations

from benchmark.reference.frontend import mel_banks

K1_FP64_OPS = 2000 + 32 * 56 + 32 * 98 + 64 * 34 + 256 * 16
FRAME_LEN, FRAME_SHIFT = 400, 160


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def k1_table_bytes(n_mel: int = 80) -> tuple[int, int]:
    """(bytes of K1's tables, non-zero mel weights)."""
    banks = mel_banks(n_mel)
    spans = [(row > 0).nonzero()[0] for row in banks]
    widths = [int(s[-1] - s[0] + 1) if s.size else 0 for s in spans]
    parts = (504 * 2 * 8, FRAME_LEN * 8, n_mel * 2 * 4,
             max(widths) * n_mel * 4)
    return sum(_round16(p) for p in parts), sum(widths)


def k1_seconds(bsz: int, width: int, frame_lens, peaks: dict,
               n_mel: int = 80) -> float:
    nf = max(0, 1 + (width - FRAME_LEN) // FRAME_SHIFT)
    fl = [min(int(f), nf) for f in frame_lens]
    tables, nnz = k1_table_bytes(n_mel)
    samples = sum((f - 1) * FRAME_SHIFT + FRAME_LEN for f in fl if f > 0)
    nbytes = 4 * samples + 4 * bsz + tables + 4 * bsz * nf * n_mel
    frames = sum(fl)
    t_ops = max(frames * K1_FP64_OPS / peaks["fp64"],
                frames * (2 * nnz + 2 * n_mel) / peaks["fp32"])
    return max(t_ops, nbytes / peaks["bytes"])


def k2_seconds(bsz: int, t_len: int, s_len: int, peaks: dict) -> float:
    elems = bsz * t_len * s_len
    return max(16 * elems / peaks["fp32"],
               4 * (2 * elems + bsz * s_len + 3 * bsz) / peaks["bytes"])


def lstm_seconds(t_len: int, bsz: int, hidden: int, peaks: dict
                 ) -> tuple[float, float]:
    """(K3's, K3b's with dU) least seconds at [T, B, H]."""
    cell = t_len * bsz * hidden
    out = []
    for flops, floats in ((2 * cell * 4 * hidden,
                           cell * (4 + 2 + 4) + 4 * hidden * hidden),
                          (4 * cell * 4 * hidden,
                           cell * (4 + 3 + 4) + 2 * 4 * hidden * hidden)):
        out.append(max(flops / peaks["fp32"], 4 * floats / peaks["bytes"]))
    return out[0], out[1]
