"""The arithmetic the reference runs in: float32 with TF32 off (the
reference), or the nearest precision below what a configuration states
(the control): TF32 for float32 with TF32 off, and for the bf16 models
fp8 (e4m3, one scale per tensor) on both operands of every product."""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale for the tensor."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@dataclasses.dataclass(frozen=True)
class Precision:
    tf32: bool = False        # TF32 products (cuBLAS and cuDNN) everywhere
    model_fp8: bool = False   # fp8 operands in the encoder's and decoder's products

    @contextlib.contextmanager
    def active(self):
        """TF32 on or off for the enclosed computation, restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if self.model_fp8 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A model product a @ b."""
        return torch.matmul(self._q(a), self._q(b))

    def conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A model convolution: x [B, C_in, L] with w [C_out, C_in, W], no padding."""
        return F.conv1d(self._q(x), self._q(w))


REFERENCE = Precision()


def control_for(config: dict) -> Precision:
    """The control of a configuration: one step below each stated precision."""
    return Precision(tf32=True, model_fp8=config["compute_dtype"] == "bfloat16")
