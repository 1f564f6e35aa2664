"""PDCNet+ model (reference models/PDCNet/PDCNet.py:479-642).

Counterpart of `binocular3dgs_tpu/init/pdcnet/model.py` (`pdcnet_forward`,
`_flow_level`) as an nn.Module whose state_dict names are the ones the JAX
forward reads, PDCNet_plus configuration (reference model_selection.py:
144-171):

  * 4-level coarse-to-fine: L-Net on 256x256 images (level 4: GlobalGOCor
    at 16^2 + CMDTop mapping decoder; level 3: LocalGOCor at 32^2 + flow
    decoder + PWC refinement `dc_conv`) and H-Net on the images themselves
    (levels 2 and 1 at 1/8 and 1/4, the final refinement `l_dc_conv`);
  * a 2-mode Laplace mixture at every level (small variance 1; large one
    in [2, 256^2] on the L-Net, [2, 520^2] on the H-Net);
  * two VGG pyramids (`pyramid` for the images, `pyramid_256`).

Decoder input widths follow the JAX concatenations: decoder4 258 = 256
global scores + 2 (a zero initial map); decoder3 and decoder2 87 = 81 local
scores + 2 flow + 4 uncertainty; decoder1 89 = + 2 of `upfeat2`; the
refinements 34 = 32 + 2; uncertainty_decoder4 38 = 6 + 32, the others
44 = 6 + 32 + 4 + 2.

Tensors are NCHW; flows (b, 2, h, w) in pixels of the corresponding image.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..correlation import local_correlation
from .decoders import CMDTopResidual, FlowEstimatorResidual, add_pwc_refinement, pwc_refinement
from .gocor import GlobalCorr, LocalGOCor, SeparableConv4d
from .layers import l2norm, resize_bilinear, unnormalise_mapping_and_convert_to_flow, warp
from .uncertainty import CorrUncertaintyDecoder, UncertaintyPredictor, constrain_large_log_var_map
from .vgg import VGGPyramid

VAR_1 = 1.0
VAR_2_MINUS = 2.0
VAR_2_PLUS = 520.0 ** 2
VAR_2_PLUS_256 = 256.0 ** 2


def _two_mode_log_var(large_log_var: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full_like(large_log_var, math.log(VAR_1)), large_log_var], dim=1)


def _upscale_uncertainty(log_var_map, weight_map, out_hw):
    up_w = resize_bilinear(weight_map, out_hw)
    up_large = resize_bilinear(log_var_map[:, 1:2], out_hw)
    return torch.cat([_two_mode_log_var(up_large), up_w], dim=1)


def _plain_global_corr(c_target, c_source):
    """use_global_corr_layer (reference base_pdcnet.py:84-103): global
    correlation of l2-normed features, relu'd, then channel-l2-normed.
    -> (b, hs*ws, h_t, w_t)."""
    t, s = l2norm(c_target), l2norm(c_source)
    b, c, h, w = t.shape
    corr = torch.bmm(s.flatten(2).transpose(1, 2), t.flatten(2))  # (b, hs ws, h w)
    return l2norm(F.relu(corr.reshape(b, -1, h, w)))


def local_plain_correlation(c_t, c_s):
    """The plain 81-shift local correlation (NCHW) that feeds the
    uncertainty decoders."""
    out = local_correlation(c_t.permute(0, 2, 3, 1), c_s.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


class PDCNetModel(nn.Module):
    def __init__(self, global_iters: int = 3, local_iters: int = 7):
        super().__init__()
        self.pyramid = VGGPyramid(n_levels=4)
        self.pyramid_256 = VGGPyramid(n_levels=5)
        self.corr = GlobalCorr(512, global_iters)
        self.local_corr = LocalGOCor(local_iters)
        self.decoder4 = CMDTopResidual(256 + 2)
        self.decoder3 = FlowEstimatorResidual(81 + 2 + 4)
        self.decoder2 = FlowEstimatorResidual(81 + 2 + 4)
        self.decoder1 = FlowEstimatorResidual(81 + 2 + 2 + 4)
        self.deconv4 = nn.ConvTranspose2d(2, 2, 4, stride=2, padding=1)
        self.deconv2 = nn.ConvTranspose2d(2, 2, 4, stride=2, padding=1)
        self.upfeat2 = nn.ConvTranspose2d(32, 2, 4, stride=2, padding=1)
        add_pwc_refinement(self, "dc_conv", 32 + 2)
        add_pwc_refinement(self, "l_dc_conv", 32 + 2)
        self.corr_uncertainty_decoder4 = CorrUncertaintyDecoder(16)
        for level in (3, 2, 1):
            self.add_module(f"corr_uncertainty_decoder{level}", CorrUncertaintyDecoder(9))
        self.uncertainty_decoder4 = UncertaintyPredictor(6 + 32)
        for level in (3, 2, 1):
            self.add_module(f"uncertainty_decoder{level}", UncertaintyPredictor(6 + 32 + 4 + 2))

    def extract_features(self, im_t, im_s, im_t_256, im_s_256):
        """reference base_matching_net.py:424-452 with make_two_feature_copies."""
        pyr_t, pyr_s = self.pyramid(im_t), self.pyramid(im_s)
        pyr_t256, pyr_s256 = self.pyramid_256(im_t_256), self.pyramid_256(im_s_256)
        return (pyr_t256[-1], pyr_s256[-1], pyr_t256[-2], pyr_s256[-2],
                pyr_t[-1], pyr_s[-1], pyr_t[-2], pyr_s[-2])

    def _uncertainty_at_level(self, corr, x_layer, up_unc, up_flow, level):
        """estimate_uncertainty_components (reference PDCNet.py:291-316)."""
        cu = getattr(self, f"corr_uncertainty_decoder{level}")(corr)
        pieces = [cu, x_layer] if up_unc is None else [cu, x_layer, up_unc, up_flow]
        return getattr(self, f"uncertainty_decoder{level}")(torch.cat(pieces, dim=1))

    def _flow_level(self, ratio, c_t, c_s, up_flow, up_unc, level, stem, up_feat, sigma_max,
                    refinement, local_iters):
        """estimate_at_flowlevel (reference PDCNet.py:369-443)."""
        c_s_warped = warp(c_s, up_flow * ratio)
        corr = F.leaky_relu(self.local_corr(c_t, c_s_warped, local_iters), 0.1)
        pieces = [corr, up_flow] + ([up_feat] if up_feat is not None else []) + [up_unc]
        x, res_flow = getattr(self, f"decoder{level}")(torch.cat(pieces, dim=1))
        x_ = torch.zeros_like(x)
        if refinement:
            x_, res_flow_ = pwc_refinement(self, stem, torch.cat([x, res_flow + up_flow], dim=1))
            res_flow = res_flow + res_flow_
        flow = res_flow + up_flow
        corr_unc = F.leaky_relu(local_plain_correlation(c_t, c_s_warped), 0.1)
        large, weight = self._uncertainty_at_level(corr_unc, x_ + x, up_unc, up_flow, level)
        large = constrain_large_log_var_map(VAR_2_MINUS, sigma_max, large)
        return x, flow, _two_mode_log_var(large), weight

    def forward(self, im_target, im_source, im_target_256, im_source_256,
                global_iters: int | None = None, local_iters: int | None = None):
        """ImageNet-normalized (b, 3, h, w) images and their 256x256 copies
        -> (output_256, output) as the reference (PDCNet.py:616-642):
        flow_estimates and uncertainty_estimates ([log_var_map, weight_map])
        per level, NCHW."""
        h_ori, w_ori = im_target.shape[-2:]
        h_256, w_256 = im_target_256.shape[-2:]
        c14, c24, c13, c23, c12, c22, c11, c21 = self.extract_features(
            im_target, im_source, im_target_256, im_source_256)

        # level 4: 16x16 global, mapping decoder (PDCNet.py:319-367)
        corr4 = F.leaky_relu(self.corr(l2norm(c14), l2norm(c24), global_iters), 0.1)
        b, _, h4, w4 = corr4.shape
        init_map = corr4.new_zeros(b, 2, h4, w4)
        x4, est_map4 = self.decoder4(torch.cat([corr4, init_map], dim=1))
        ratio = corr4.new_tensor([16.0 / float(w_256), 16.0 / float(h_256)]).view(1, 2, 1, 1)
        flow4 = unnormalise_mapping_and_convert_to_flow(est_map4) / ratio
        large4, weight4 = self._uncertainty_at_level(_plain_global_corr(c14, c24), x4, None,
                                                     None, 4)
        log_var4 = _two_mode_log_var(constrain_large_log_var_map(VAR_2_MINUS, VAR_2_PLUS_256,
                                                                 large4))

        # level 3: 32x32 local (PDCNet.py:446-513)
        up_flow4 = self.deconv4(flow4)
        up_unc4 = _upscale_uncertainty(log_var4, weight4, (32, 32))
        x3, flow3, log_var3, weight3 = self._flow_level(
            32.0 / float(w_256), c13, c23, up_flow4, up_unc4, 3, "dc_conv", None,
            VAR_2_PLUS_256, True, local_iters)

        # level 2: 1/8, no refinement (refinement_at_all_levels=False)
        out_hw_8 = (h_ori // 8, w_ori // 8)
        scale = flow3.new_tensor([float(w_ori) / float(w_256),
                                  float(h_ori) / float(h_256)]).view(1, 2, 1, 1)
        up_flow3 = resize_bilinear(flow3, out_hw_8) * scale
        up_unc3 = _upscale_uncertainty(log_var3, weight3, out_hw_8)
        x2, flow2, log_var2, weight2 = self._flow_level(
            1.0 / 8.0, c12, c22, up_flow3, up_unc3, 2, "l_dc_conv", None, VAR_2_PLUS, False,
            local_iters)

        # level 1: 1/4, final PWC refinement
        out_hw_4 = (h_ori // 4, w_ori // 4)
        up_flow2 = self.deconv2(flow2)
        up_feat2 = self.upfeat2(x2)
        up_unc2 = _upscale_uncertainty(log_var2, weight2, out_hw_4)
        x1, flow1, log_var1, weight1 = self._flow_level(
            1.0 / 4.0, c11, c21, up_flow2, up_unc2, 1, "l_dc_conv", up_feat2, VAR_2_PLUS, True,
            local_iters)

        output_256 = {"flow_estimates": [flow4, flow3], "correlation": corr4,
                      "uncertainty_estimates": [[log_var4, weight4], [log_var3, weight3]]}
        output = {"flow_estimates": [flow2, flow1],
                  "uncertainty_estimates": [[log_var2, weight2], [log_var1, weight1]]}
        return output_256, output


def random_model(seed: int = 0, **kwargs) -> PDCNetModel:
    """A PDCNetModel with seeded random weights, in eval mode, for checks
    without a checkpoint. Every draw comes from `torch.Generator(seed)`:
    each convolution's weight and bias uniform in +-1/sqrt(fan_in), as
    PyTorch's default initialisation draws them; the 4D regularizer N(0,
    1e-3); BatchNorm means N(0, 0.1) and variances U(0.5, 1.5), so that
    eval-mode BN is not the identity and no variance is 0. GOCor's scalars
    and bin predictors keep the values their constructors set."""
    gen = torch.Generator().manual_seed(seed)
    model = PDCNetModel(**kwargs)
    fixed = {id(m) for opt in (model.corr.corr_module.filter_optimizer,
                               model.local_corr.filter_optimizer)
             for m in (opt.label_map_predictor, opt.spatial_weight_predictor,
                       opt.target_mask_predictor[0])}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and id(m) not in fixed:
                bound = 1.0 / math.sqrt(m.weight[0].numel())  # fan_in of both kinds
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, SeparableConv4d):
                m.weight1.normal_(0.0, 1e-3, generator=gen)
                m.weight2.normal_(0.0, 1e-3, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.eval()
