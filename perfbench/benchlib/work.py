"""Work counts and the card's peaks: the yardstick of the roofline and
utilization metrics, worked out from a cell's shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 on
the tensor cores, 3.35 TB/s of HBM3.

- A GRU scan of one direction (T steps, B rows, H units): 6 T B H^2 FLOP
  (the two recurrent products of a step) at the operand type's peak;
  bytes gx, cx in and ys out (4 T B H operands) and the 3 H^2 recurrent
  weights, each once.
- The bank convolutions of a CBHG: bank k has width k, so the nonzero taps
  are K (K+1) / 2 of the K^2 a packed width-K convolution holds: 2 N C 128
  K (K+1)/2 FLOP for N frames of C channels; bytes the input, the K*128
  output channels and the nonzero weights, each once.
- The model: every product of the encoder and decoder at its nonzero taps
  (prenets, banks, projections, highways, the GRUs' input and recurrent
  products, output layers), 2 FLOP a multiply-add.
- The vocoder: each transform of n points counted as an FFT, 5 n log2 n:
  one for the features' STFT of each frame, 2 r - 1 for r Griffin-Lim
  rounds, whatever the program uses for a DFT.
"""

from __future__ import annotations

import math

from .weights import BANK_CHANNELS, dims

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


def _bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)


def scan_bound_s(T: int, B: int, H: int, dtype: str) -> float:
    """Least seconds of one direction's scan."""
    e = ELEM_BYTES[dtype]
    return _bound_s(6 * T * B * H * H, e * (4 * T * B * H + 3 * H * H), dtype)


def cbhg_stacks(config: dict) -> list[dict]:
    d = dims(config)
    return [d["encoder"], d["step1"], d["step2"]]


def scans_bound_s(config: dict, T: int, B: int) -> float:
    """Least seconds of the six scans (three CBHG stacks, two directions)
    of one model pass over B sequences of T frames."""
    dtype = config["compute_dtype"]
    return sum(2 * scan_bound_s(T, B, s["embed"] // 2, dtype) for s in cbhg_stacks(config))


def bank_taps(K: int) -> int:
    return K * (K + 1) // 2


def banks_bound_s(config: dict, frames: int) -> float:
    """Least seconds of the three bank convolutions over ``frames`` frames."""
    dtype = config["compute_dtype"]
    e = ELEM_BYTES[dtype]
    total = 0.0
    for s in cbhg_stacks(config):
        C, K = s["embed"] // 2, s["K"]
        flops = 2 * frames * C * BANK_CHANNELS * bank_taps(K)
        nbytes = e * (frames * C + frames * K * BANK_CHANNELS + BANK_CHANNELS * C * bank_taps(K))
        total += _bound_s(flops, nbytes, dtype)
    return total


def _stack_flops(s: dict) -> int:
    """FLOP a frame of one prenet + CBHG + output layer."""
    E, E2, K = s["embed"], s["embed"] // 2, s["K"]
    f = 2 * (s["in"] * E + E * E2)                          # prenet
    f += 2 * E2 * BANK_CHANNELS * bank_taps(K)              # banks, nonzero taps
    f += 2 * 3 * K * BANK_CHANNELS * E2 + 2 * 3 * E2 * E2   # two projections
    f += s["highway"] * 2 * 2 * E2 * E2                     # highways
    f += 2 * (2 * E2 * 3 * E2 + 6 * E2 * E2)                # GRU: input and recurrent, 2 dirs
    f += 2 * E * s["out"]                                   # output layer
    return f


def model_flops_per_frame(config: dict) -> int:
    return sum(_stack_flops(s) for s in cbhg_stacks(config))


def fft_flops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def n_fft(config: dict) -> int:
    f = config["features"]
    return f["n_fft"] or int(f["win_length_ms"] * f["sample_rate"] / 1000.0)


def step_seconds_at_peak(config: dict, model_frames: int, feature_frames: int,
                         vocoder_frames: int, rounds: int) -> float:
    """Least seconds of a unit of work at the card's peaks: the model's
    FLOP at the compute type's peak, the transforms at the float32 peak."""
    model = model_flops_per_frame(config) * model_frames / PEAK_FLOPS[config["compute_dtype"]]
    transforms = (feature_frames + (2 * rounds - 1) * vocoder_frames) * fft_flops(n_fft(config))
    return model + transforms / PEAK_FLOPS["float32"]
