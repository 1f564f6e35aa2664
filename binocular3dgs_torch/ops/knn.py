"""Mean squared distance to the 3 nearest neighbours.

Counterpart of `binocular3dgs_tpu/ops/knn.py` (simple-knn `distCUDA2`,
reference `submodules/simple-knn/simple_knn.cu:147-183`): for each point,
the mean of the squared distances to its 3 exact nearest neighbours, self
excluded. Blocked brute force in plain PyTorch: one (B, 3) x (3, P) matmul
per block, as the JAX version; it runs once per training job.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def mean_sq_dist_3nn(points: torch.Tensor, block_size: int = 1024) -> torch.Tensor:
    """points (P, 3) -> (P,) mean of the squared distances to the 3 exact
    nearest neighbours (callers clamp at 1e-7, reference
    `scene/gaussian_model.py:134-135`)."""
    points = points.float()
    P = points.shape[0]
    sq_norms = torch.sum(points * points, dim=-1)
    out = torch.empty(P, device=points.device)
    for start in range(0, P, block_size):
        blk = points[start:start + block_size]
        blk_sq = torch.sum(blk * blk, dim=-1)
        d2 = torch.clamp(blk_sq[:, None] + sq_norms[None, :] - 2.0 * (blk @ points.T), min=0.0)
        rows = torch.arange(blk.shape[0], device=points.device)
        d2[rows, start + rows] = torch.inf  # self
        out[start:start + block_size] = torch.topk(d2, 3, dim=-1, largest=False).values.mean(-1)
    return out
