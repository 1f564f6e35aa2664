"""Global and Local GOCor: learned correlation by unrolled steepest descent.

Counterpart of `binocular3dgs_tpu/init/pdcnet/gocor.py` (reference
third_party/GOCor/GOCor/{global_gocor,local_gocor,global_corr_initializer,
fourdim,distance,activation}.py), PDCNet_plus configuration (reference
model_selection.py:144-171): global 3 iterations, steplength_reg 0.1, query
loss through SeparableConv4d(3, 16, 16); local 7 iterations, 9x9 window,
no query loss.

The state_dict names are the reference's:
  {prefix}.filter_initializer.target_fg / .target_bg   (global, (d,))
  {prefix}.filter_initializer.scaling                 (local, (1,))
  {prefix}.filter_optimizer.log_step_length / .filter_reg           (1,)
  {prefix}.filter_optimizer.label_map_predictor.weight             (1, 10, 1, 1)
  {prefix}.filter_optimizer.spatial_weight_predictor.weight        (1, 10, 1, 1)
  {prefix}.filter_optimizer.target_mask_predictor.0.weight         (1, 10, 1, 1)
  {prefix}.filter_optimizer.reg_layer.weight1 / .weight2  (global, (16, 1, 3, 3), (16, 16, 3, 3))
Their initial values are those of the reference constructors (init step
length 1, filter_reg 1e-2, a Gaussian label map of sigma 1 less its
minimum, spatial weights 1, target mask 4 tanh(2 - d), target_fg 1,
target_bg 0, scaling 1, the 4D regularizer's weights N(0, 1e-3)), as we
read them.

The global filter map is (b, H W, d): one 1x1 filter per reference
position, so every filter-feature product is one batched matmul. The local
optimizer runs channels-last on `init/correlation.py`'s 81-shift
correlation and its transpose, as the JAX one does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..correlation import local_correlation, local_correlation_transpose

NUM_DIST_BINS, BIN_DISPLACEMENT = 10, 0.5


def distance_bins(offsets_y: torch.Tensor, offsets_x: torch.Tensor,
                  num_bins: int = NUM_DIST_BINS, bin_displacement: float = BIN_DISPLACEMENT):
    """DistanceMap: per-offset triangular histogram over distance bins.
    offsets: (H,) and (W,) -> (H, W, num_bins)."""
    dist = torch.sqrt(offsets_y[:, None] ** 2 + offsets_x[None, :] ** 2)
    centers = torch.arange(num_bins, dtype=dist.dtype, device=dist.device)
    diff = dist[..., None] / bin_displacement - centers
    tri = torch.clamp(1.0 - diff[..., :-1].abs(), min=0.0)
    last = torch.clamp(1.0 + diff[..., -1:], 0.0, 1.0)
    return torch.cat([tri, last], dim=-1)


def leaky_relu_par(x, a):
    return (1.0 - a) / 2.0 * x.abs() + (1.0 + a) / 2.0 * x


def leaky_relu_par_deriv(x, a):
    return (1.0 - a) / 2.0 * torch.sign(x) + (1.0 + a) / 2.0


class FilterOptimizer(nn.Module):
    """The optimizer's learned scalars and bin predictors (reference
    GlobalGOCorOpt / LocalGOCorrOpt constructors), plus the query loss's
    SeparableConv4d for the global one."""

    def __init__(self, query_loss: bool):
        super().__init__()
        self.log_step_length = nn.Parameter(torch.zeros(1))  # log(1.0)
        self.filter_reg = nn.Parameter(torch.full((1,), 1e-2))
        d = torch.arange(NUM_DIST_BINS, dtype=torch.float32).view(1, -1, 1, 1) * BIN_DISPLACEMENT
        gauss = torch.exp(-0.5 * d ** 2)
        self.label_map_predictor = nn.Conv2d(NUM_DIST_BINS, 1, 1, bias=False)
        self.spatial_weight_predictor = nn.Conv2d(NUM_DIST_BINS, 1, 1, bias=False)
        self.target_mask_predictor = nn.Sequential(nn.Conv2d(NUM_DIST_BINS, 1, 1, bias=False),
                                                   nn.Sigmoid())
        with torch.no_grad():
            self.label_map_predictor.weight.copy_(gauss - gauss.min())
            self.spatial_weight_predictor.weight.fill_(1.0)
            self.target_mask_predictor[0].weight.copy_(4.0 * torch.tanh(2.0 - d))
        if query_loss:
            self.reg_layer = SeparableConv4d()

    def bin_maps(self, bins: torch.Tensor):
        """(label map, v_plus, target mask) over a (..., bins) histogram."""

        def predict(conv):
            return bins @ conv.weight.reshape(-1)

        return (predict(self.label_map_predictor), predict(self.spatial_weight_predictor),
                torch.sigmoid(predict(self.target_mask_predictor[0])))

    def reg_weight(self, min_filter_reg: float = 1e-5):
        freg = self.filter_reg[0]
        return torch.clamp(freg * freg, min=min_filter_reg ** 2)


class SeparableConv4d(nn.Module):
    """reference fourdim.py SeparableConv4d(3, 16, 16), bias=False,
    permute_back_output=False: conv1 (1 -> inter) over the last spatial
    pair, conv2 (inter -> out) over the first."""

    def __init__(self, kernel_size: int = 3, inter_dim: int = 16, output_dim: int = 16):
        super().__init__()
        self.weight1 = nn.Parameter(torch.empty(inter_dim, 1, kernel_size, kernel_size))
        self.weight2 = nn.Parameter(torch.empty(output_dim, inter_dim, kernel_size, kernel_size))
        nn.init.normal_(self.weight1, 0.0, 1e-3)
        nn.init.normal_(self.weight2, 0.0, 1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, H, W, H2, W2) -> (b, H2, W2, out, H, W)."""
        b, H, W, H2, W2 = x.shape
        p = self.weight1.shape[-1] // 2
        x2 = F.conv2d(x.reshape(b * H * W, 1, H2, W2), self.weight1, padding=p)
        inter = x2.shape[1]
        x2 = x2.reshape(b, H, W, inter, H2, W2).permute(0, 4, 5, 3, 1, 2)
        x3 = F.conv2d(x2.reshape(b * H2 * W2, inter, H, W), self.weight2, padding=p)
        return x3.reshape(b, H2, W2, -1, H, W)

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        """The adjoint: (b, H2, W2, out, H, W) -> (b, H, W, H2, W2)."""
        b, H2, W2, out, H, W = x.shape
        p = self.weight1.shape[-1] // 2
        x2 = F.conv_transpose2d(x.reshape(b * H2 * W2, out, H, W), self.weight2, padding=p)
        inter = x2.shape[1]
        x2 = x2.reshape(b, H2, W2, inter, H, W).permute(0, 4, 5, 3, 1, 2)
        x3 = F.conv_transpose2d(x2.reshape(b * H * W, inter, H2, W2), self.weight1, padding=p)
        return x3.reshape(b, H, W, H2, W2)


def _global_unfold_map(g: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """From a (2H-1, 2W-1) offset map g (zero offset at the centre):
    map[(py, px) flat, y, x] = g[H-1 + y - py, W-1 + x - px]."""
    iy = torch.as_tensor((H - 1) + np.arange(H)[None, :] - np.arange(H)[:, None], device=g.device)
    ix = torch.as_tensor((W - 1) + np.arange(W)[None, :] - np.arange(W)[:, None], device=g.device)
    return g[iy[:, None, :, None], ix[None, :, None, :]].reshape(H * W, H, W)


class FlexibleContextAwareInitializer(nn.Module):
    """GlobalCorrFlexibleContextAwareInitializer (reference
    global_corr_initializer.py:139-188)."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.target_fg = nn.Parameter(torch.ones(feature_dim))
        self.target_bg = nn.Parameter(torch.zeros(feature_dim))

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        """w: (b, HW, d) -> the initial filter map (b, HW, d)."""
        bg = w.mean(dim=1, keepdim=True)
        ff = (w * w).sum(dim=2, keepdim=True)
        bb = (bg * bg).sum(dim=2, keepdim=True)
        fb = (w * bg).sum(dim=2, keepdim=True)
        den = torch.clamp(ff * bb - fb * fb, min=1e-6)
        fg_scale = self.target_fg * bb - self.target_bg * fb
        bg_scale = self.target_fg * fb - self.target_bg * ff
        return (fg_scale * w - bg_scale * bg) / den


class GlobalGOCor(nn.Module):
    """GlobalGOCor forward (reference global_gocor.py:145-354)."""

    def __init__(self, feature_dim: int = 512, num_iter: int = 3, steplength_reg: float = 0.1):
        super().__init__()
        self.num_iter, self.steplength_reg = num_iter, steplength_reg
        self.filter_initializer = FlexibleContextAwareInitializer(feature_dim)
        self.filter_optimizer = FilterOptimizer(query_loss=True)

    def forward(self, ref_feat: torch.Tensor, query_feat: torch.Tensor,
                num_iter: int | None = None) -> torch.Tensor:
        """ref_feat, query_feat: (b, d, H, W), L2-normalized by the caller.
        Returns scores (b, H2 W2, H, W): spatial = reference position,
        channel = query position (put_query_feat_in_channel_dimension)."""
        num_iter = self.num_iter if num_iter is None else num_iter
        opt = self.filter_optimizer
        b, d, H, W = ref_feat.shape
        H2, W2 = query_feat.shape[-2:]
        rf = ref_feat.flatten(2).transpose(1, 2)  # (b, HW, d)
        qf = query_feat.flatten(2).transpose(1, 2)
        filter_map = self.filter_initializer(rf)

        offs_y = torch.arange(-(H - 1), H, dtype=rf.dtype, device=rf.device)
        offs_x = torch.arange(-(W - 1), W, dtype=rf.dtype, device=rf.device)
        maps = opt.bin_maps(distance_bins(offs_y, offs_x))
        target_map, v_plus, weight_m = (_global_unfold_map(m, H, W)[None] for m in maps)
        step_length = torch.exp(opt.log_step_length)[0]
        reg_weight = opt.reg_weight()

        def apply_filter(feat, filt, h, w):  # (b, P, d) x (b, N, d) -> (b, N, h, w)
            return torch.bmm(filt, feat.transpose(1, 2)).reshape(b, -1, h, w)

        def feat_transpose(feat, res, h, w):  # (b, N, h, w) x (b, P, d) -> (b, N, d)
            return torch.bmm(res.reshape(b, -1, h * w), feat)

        for _ in range(num_iter):
            scores_ref = apply_filter(rf, filter_map, H, W)
            act = v_plus * leaky_relu_par(scores_ref, weight_m)
            dact = v_plus * leaky_relu_par_deriv(scores_ref, weight_m)
            residuals = dact * (act - v_plus * target_map)
            filter_grad = reg_weight * filter_map + feat_transpose(rf, residuals, H, W)

            scores_q = apply_filter(qf, filter_map, H2, W2).reshape(b, H, W, H2, W2)
            reg_tp = opt.reg_layer.transpose(opt.reg_layer(scores_q))
            filter_grad = filter_grad + feat_transpose(qf, reg_tp.reshape(b, H * W, H2, W2), H2, W2)

            sg_ref = dact * apply_filter(rf, filter_grad, H, W)
            alpha_den = (sg_ref.reshape(b, -1) ** 2).sum(1)
            sg_q = apply_filter(qf, filter_grad, H2, W2).reshape(b, H, W, H2, W2)
            alpha_den = alpha_den + (opt.reg_layer(sg_q).reshape(b, -1) ** 2).sum(1)
            alpha_num = (filter_grad.reshape(b, -1) ** 2).sum(1)
            alpha_den = torch.clamp(alpha_den + reg_weight * alpha_num, min=1e-8)
            alpha_den = alpha_den + self.steplength_reg * alpha_num
            alpha = alpha_num / alpha_den
            filter_map = filter_map - (step_length * alpha)[:, None, None] * filter_grad

        scores = torch.bmm(filter_map, qf.transpose(1, 2))  # (b, HW_ref, H2 W2)
        return scores.transpose(1, 2).reshape(b, H2 * W2, H, W)


class GlobalCorr(nn.Module):
    """Holds the GlobalGOCor as `corr_module`, so that its names are
    `corr.corr_module.*` as in the reference (GlobalGOCorWithFlexibleContextAwareInitializer
    wrapped in PDCNet's `self.corr`)."""

    def __init__(self, feature_dim: int = 512, num_iter: int = 3):
        super().__init__()
        self.corr_module = GlobalGOCor(feature_dim, num_iter)

    def forward(self, ref_feat, query_feat, num_iter=None):
        return self.corr_module(ref_feat, query_feat, num_iter)


class LocalSimpleInitializer(nn.Module):
    """LocalCorrSimpleInitializer (reference local_gocor.py:35-58)."""

    def __init__(self):
        super().__init__()
        self.scaling = nn.Parameter(torch.ones(1))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """feat: (b, H, W, d) channels-last."""
        return self.scaling[0] * feat / ((feat * feat).mean(dim=-1, keepdim=True) + 1e-6)


class LocalGOCor(nn.Module):
    """LocalGOCor forward (reference local_gocor.py:334-430), 9x9 window,
    reference loss only."""

    def __init__(self, num_iter: int = 7, md: int = 4):
        super().__init__()
        self.num_iter, self.md = num_iter, md
        self.filter_initializer = LocalSimpleInitializer()
        self.filter_optimizer = FilterOptimizer(query_loss=False)

    def forward(self, ref_feat: torch.Tensor, query_feat: torch.Tensor,
                num_iter: int | None = None) -> torch.Tensor:
        """(b, d, H, W) each -> cost volume (b, 81, H, W)."""
        num_iter = self.num_iter if num_iter is None else num_iter
        md, opt = self.md, self.filter_optimizer
        ref = ref_feat.permute(0, 2, 3, 1).contiguous()
        query = query_feat.permute(0, 2, 3, 1).contiguous()
        d = ref.shape[-1]
        filter_map = self.filter_initializer(ref)

        offs = torch.arange(-md, md + 1, dtype=ref.dtype, device=ref.device)
        target_map, v_plus, weight_m = (m.reshape(1, 1, 1, -1)
                                        for m in opt.bin_maps(distance_bins(offs, offs)))
        step_length = torch.exp(opt.log_step_length)[0]
        reg_weight = opt.reg_weight() / (d * d)

        for _ in range(num_iter):
            scores = local_correlation(filter_map, ref, md)
            act = v_plus * leaky_relu_par(scores, weight_m)
            dact = v_plus * leaky_relu_par_deriv(scores, weight_m)
            residuals = dact * (act - v_plus * target_map)
            filter_grad = reg_weight * filter_map + local_correlation_transpose(residuals, ref, md)

            sg = dact * local_correlation(filter_grad, ref, md)
            alpha_den = (sg * sg).sum(dim=-1, keepdim=True)
            alpha_num = (filter_grad * filter_grad).sum(dim=-1, keepdim=True)
            alpha_den = torch.clamp(alpha_den + reg_weight * alpha_num, min=1e-8)
            alpha = alpha_num / alpha_den
            filter_map = filter_map - (step_length * alpha) * filter_grad

        return local_correlation(filter_map, query, md).permute(0, 3, 1, 2)
