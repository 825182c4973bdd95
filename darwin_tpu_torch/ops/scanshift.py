"""The scan-lowering probe: chained inclusive prefix-max scans.

The port of tools/scanshift_probe.py's kernel (the pallas_call in `one`,
line 97; kernel :76-85): for each row of x [B, C] int32, STEPS chained
scans ``u = cummax(u + s)`` for s = 0..STEPS-1.  The TPU probe lowers
the DP's shift-max scan two ways (concat-shift, roll+mask); the CUDA
kernel (csrc/scanshift.cu) runs one warp a row, each lane holding
ceil(C/32) contiguous columns in registers through all the scans, and
lowers the scan of the 32 lane totals two GPU ways:

* scanshift_shfl: five warp shuffles;
* scanshift_smem: a Hillis-Steele scan in shared memory under
  __syncwarp.

The plain version, scanshift_torch, uses torch.cummax.  A CPU tensor
takes it; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from darwin_tpu_torch import _build

STEPS = 16  # scans per row, as the probe (tools/scanshift_probe.py:25)
MAX_WIDTH = 1024  # 32 columns a lane, one warp a row
_LOWERINGS = {"shfl": 0, "smem": 1}


def scanshift_torch(x: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """x [B, C] int32 -> [B, C] int32 after `steps` chained scans."""
    u = x
    for s in range(steps):
        u = torch.cummax(u + s, dim=1).values
    return u


def _scan(x: torch.Tensor, steps: int, lowering: str) -> torch.Tensor:
    what = f"scanshift_{lowering}"
    dev = _build.require_cuda(x, what)
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [B, C], got {tuple(x.shape)}")
    B, C = x.shape
    if not 1 <= C <= MAX_WIDTH:
        raise ValueError(f"{what}: width {C} outside 1..{MAX_WIDTH}")
    xp = _build.arg(x, "x", torch.int32, (B, C), dev)
    out = torch.empty_like(x)
    if B:
        _build.launch("dtt_scanshift", dev, xp, B, C, steps,
                      _LOWERINGS[lowering], out)
    return out


def scanshift_shfl(x: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """Lowering (a): the lane totals scanned by warp shuffles."""
    if x.device.type == "cpu":
        return scanshift_torch(x, steps)
    out = _scan(x, steps, "shfl")
    if x.shape[0]:
        scanshift_shfl.launches += 1
    return out


def scanshift_smem(x: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """Lowering (b): the lane totals scanned in shared memory."""
    if x.device.type == "cpu":
        return scanshift_torch(x, steps)
    out = _scan(x, steps, "smem")
    if x.shape[0]:
        scanshift_smem.launches += 1
    return out


scanshift_shfl.launches = 0
scanshift_smem.launches = 0
