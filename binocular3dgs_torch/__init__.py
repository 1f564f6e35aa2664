"""binocular3dgs_torch — PyTorch/CUDA port of binocular3dgs_tpu for NVIDIA Hopper.

The JAX package `binocular3dgs_tpu` is the reference this port is held
against; the port never imports it (nor JAX). Plain tensor code is PyTorch;
each TPU Pallas kernel on a ported path is a hand-written CUDA kernel for
`sm_90a` under `csrc/`, built with nvcc at first use (ops/cuda_build.py).

Ported so far: the serving path — load a trained scene, render views
(project -> bin -> gather -> blend -> planes) and spiral paths, score them
(PSNR/SSIM, LPIPS from supplied weights), the viewer protocol — and the
training path: the binocular train step (two renders, the disparity warp,
losses, autograd through the blend and warp kernels, masked Adam),
densification and the trainer behind `cli train`, with checkpoints that
interchange with the JAX package's and a profiler trace; and the dense init
behind `cli triangulate` (its own Farneback flow, `init/`) and the per-scene
pipeline behind `cli run` (`orchestrate.py`).
"""

from __future__ import annotations

__version__ = "0.1.0"

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent (no silent CPU fallback).

    Also turns TF32 off for matmuls and cuDNN convolutions: float32 work on
    the card must be float32. The JAX package lost a round to silent
    reduced-precision TPU matmuls (`binocular3dgs_tpu/__init__.py`); on
    Hopper the same trap is TF32, which cuDNN convolutions use by default.

    And it restricts cuDNN to its deterministic algorithms (and turns its
    benchmark search off), so that a convolution's backward, SSIM's above
    all, adds in the same order on every run and training repeats bit for
    bit.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return device
