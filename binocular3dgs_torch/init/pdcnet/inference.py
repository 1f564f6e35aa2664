"""PDCNet+ inference: pre-processing, direct / 2-stage homography /
multiscale estimation, cyclic consistency and match extraction.

Counterpart of `binocular3dgs_tpu/init/pdcnet/inference.py` (reference
models/base_matching_net.py:75-147, models/PDCNet/base_pdcnet.py:144-757,
models/inference_utils.py:16-325), with the same functions and parameters.
Everything runs on the matcher's device: the network, the masks, the
RANSAC homography and the perspective warp (`homography.py`, the port's
own in place of OpenCV's). Flows and uncertainty maps are NHWC tensors,
(1, h, w, 2) and (1, h, w, k), as the JAX package returns them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device
from .convert import load_checkpoint, load_into
from .homography import find_homography_ransac, warp_perspective
from .layers import pixel_grid, resize_area, resize_bilinear, sample_by_mapping, warp
from .model import PDCNetModel
from .uncertainty import average_variance_of_mixture, p_r_of_mixture

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

DEFAULT_INFERENCE_PARAMETERS = {
    # reference base_pdcnet.py:45-53 defaults, overridden by triangulate.py:20-28
    "R": 1.0,
    "ransac_thresh": 1.0,
    "multi_stage_type": "h",
    "mask_type": "proba_interval_1_above_10",
    "homography_visibility_mask": True,
    "compute_cyclic_consistency_error": True,
    # multiscale ('ms') knobs, reference base_pdcnet.py:45-53
    "list_resizing_ratios": [0.5, 0.6, 0.88, 1, 1.33, 1.66, 2],
    "min_inlier_threshold_for_multi_scale": 0.2,
    "min_nbr_points_for_multi_scale": 70,
}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _warp_nhwc(x, flow):
    """layers.warp on NHWC tensors."""
    return _nhwc(warp(_nchw(x), _nchw(flow)))


def _sample_by_mapping_nhwc(x, mapping):
    return _nhwc(sample_by_mapping(_nchw(x), _nchw(mapping)))


def _resize_nhwc(x, out_hw):
    return _nhwc(resize_bilinear(_nchw(x), out_hw))


def _grid_nhwc(flow: torch.Tensor) -> torch.Tensor:
    """(1, h, w, 2) pixel positions of an NHWC flow's grid."""
    return _nhwc(pixel_grid(flow.shape[1], flow.shape[2], flow))


# ---------------------------------------------------------------------------
# masks, matches, homographies (reference inference_utils.py)
# ---------------------------------------------------------------------------


def estimate_mask(mask_type: str, uncertainty_est: dict, R: float = 1.0) -> torch.Tensor:
    """reference inference_utils.py:16-119 (the variants the pipeline uses)
    -> (1, h, w) bool."""
    if "cyclic_consistency_error_below" in mask_type:
        thresh = float(mask_type.split("below_", 1)[-1])
        return uncertainty_est["cyclic_consistency_error"][..., 0] <= thresh
    if "variance_below" in mask_type:
        thresh = float(mask_type.split("variance_below_", 1)[-1])
        return uncertainty_est["variance"][..., 0] <= thresh
    if "proba_interval" in mask_type:
        min_confidence = float(mask_type.split("above_", 1)[-1])
        r = float(mask_type.split("interval_", 1)[1].split("_above_", 1)[0])
        if "p_r" in uncertainty_est and r == R:
            p_r = uncertainty_est["p_r"]
        else:
            p_r = p_r_of_mixture(uncertainty_est["weight_map"], uncertainty_est["log_var_map"],
                                 R=r, dim=-1)
        return p_r[..., 0] >= min_confidence / 100.0
    raise ValueError(f"unknown mask type {mask_type}")


def matches_from_flow(flow: torch.Tensor, mask: torch.Tensor, scaling=1.0):
    """reference inference_utils.py:122-163. flow (b, h, w, 2), mask
    (b, h, w) -> (source points (N, 2), target points (N, 2)) float32,
    row-major over the mask."""
    grid = _grid_nhwc(flow).expand(flow.shape)
    scaling = torch.as_tensor(np.array(scaling, np.float32), device=flow.device)
    return (flow + grid)[mask] * scaling, grid[mask] * scaling


def homography_is_accepted(H: np.ndarray) -> bool:
    """reference inference_utils.py:199-229."""
    H = H / H[2, 2]
    det = H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]
    if det < 0:
        return False
    n1 = np.sqrt(H[0, 0] ** 2 + H[1, 0] ** 2)
    n2 = np.sqrt(H[0, 1] ** 2 + H[1, 1] ** 2)
    return bool(0.001 <= n1 <= 100 and 0.001 <= n2 <= 100)


def from_homography_to_pixel_wise_mapping(shape, H: np.ndarray, device) -> torch.Tensor:
    """reference inference_utils.py:166-197: each pixel of an (h, w) grid
    sent through H -> (h, w, 2) float32 (computed in float64)."""
    h, w = shape[:2]
    Ht = torch.as_tensor(np.asarray(H, np.float64), device=device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    xyh = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs.reshape(-1))])
    warped = Ht @ xyh
    mx = (warped[0] / (warped[2] + 1e-8)).reshape(h, w)
    my = (warped[1] / (warped[2] + 1e-8)).reshape(h, w)
    return torch.stack([mx, my], dim=-1).float()


def estimate_homography_and_inliers(flow, mask, scaling=1.0, min_nbr_points=0,
                                    ransac_thresh=1.0):
    """reference inference_utils.py:294-325: the RANSAC homography of the
    confident matches and its inlier count, or (None, 0)."""
    mkpts_src, mkpts_tgt = matches_from_flow(flow, mask, scaling=scaling)
    if len(mkpts_tgt) <= min_nbr_points:
        return None, 0
    H, inliers = find_homography_ransac(mkpts_src, mkpts_tgt, ransac_thresh, max_iters=3000)
    if H is None or not homography_is_accepted(H):
        return None, 0
    return H, int(inliers.sum())


def pad_to_size(im: torch.Tensor, size) -> torch.Tensor:
    """Bottom/right zero-pad an (h, w, C) image to `size` (reference
    base_pdcnet.py:19-34)."""
    pad_y = max(size[0] - im.shape[0], 0)
    pad_x = max(size[1] - im.shape[1], 0)
    return F.pad(im, (0, 0, 0, pad_x, 0, pad_y))


def estimate_homography_and_correspondence_map(flow, mask, original_shape,
                                               mapping_output_shape, scaling,
                                               ransac_thresh=1.0, min_nbr_points=200):
    """reference inference_utils.py:229-297 -> (H at image scale, mapping
    (1, h, w, 2) at mapping_output_shape) or (None, None)."""
    mkpts_src, mkpts_tgt = matches_from_flow(flow, mask, scaling=scaling)
    if len(mkpts_tgt) <= min_nbr_points:
        return None, None
    H, _ = find_homography_ransac(mkpts_src, mkpts_tgt, ransac_thresh, max_iters=3000)
    if H is None or not homography_is_accepted(H):
        return None, None
    mapping = from_homography_to_pixel_wise_mapping(original_shape, np.linalg.inv(H),
                                                    flow.device)[None]
    if mapping_output_shape is not None and tuple(mapping_output_shape) != tuple(original_shape):
        oh, ow = original_shape
        nh, nw = mapping_output_shape
        scale = torch.tensor([(nw - 1) / (ow - 1), (nh - 1) / (oh - 1)], dtype=torch.float32,
                             device=flow.device)
        mapping = _resize_nhwc(mapping, (nh, nw)) * scale
    return H, mapping


def _preprocess_shapes(h, w):
    ph = 256 if h < 256 else int(h // 8) * 8
    pw = 256 if w < 256 else int(w // 8) * 8
    return ph, pw


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------


class PDCNetPlus:
    """PDCNet+ matcher (reference `select_model('PDCNet_plus', 'megadepth')`,
    model_selection.py:144-254) on `device`. `weights` is a checkpoint path
    (reference `.pth`/`.pth.tar`, or the npz both packages read) or a
    torch-layout state_dict; images are (H, W, 3) in [0, 255], numpy
    arrays or tensors."""

    def __init__(self, weights, inference_parameters=None, global_optim_iter=3,
                 local_optim_iter=7, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if isinstance(weights, str):
            weights = load_checkpoint(weights)
        self.model = load_into(PDCNetModel(), weights).to(self.device).eval()
        self.inference_parameters = dict(DEFAULT_INFERENCE_PARAMETERS)
        if inference_parameters:
            self.inference_parameters.update(inference_parameters)
        self.global_iters = int(global_optim_iter)
        self.local_iters = int(local_optim_iter)
        self._mean = torch.tensor(_IMAGENET_MEAN, device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(_IMAGENET_STD, device=self.device).view(1, 3, 1, 1)

    def _image(self, image) -> torch.Tensor:
        """(H, W, 3) array or tensor -> (H, W, 3) float32 on the device (a
        uint8 image crosses to the card as uint8)."""
        img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
        return img.to(self.device).float()

    def _forward(self, source, target, out_h, out_w):
        """source/target (1, 3, H, W) float32 in [0, 255] at the /8 working
        size -> flow, log_var, weight (NHWC) resized to (out_h, out_w), the
        flow in working-resolution pixels."""

        def norm(x):
            return (x / 255.0 - self._mean) / self._std

        src_256 = resize_area(source, (256, 256))
        tgt_256 = resize_area(target, (256, 256))
        with torch.inference_mode():
            _, output = self.model(norm(target), norm(source), norm(tgt_256), norm(src_256),
                                   self.global_iters, self.local_iters)
        flow = output["flow_estimates"][-1]
        log_var, weight = output["uncertainty_estimates"][-1]
        return tuple(_nhwc(resize_bilinear(t, (out_h, out_w))) for t in (flow, log_var, weight))

    # -- direct single-pass estimation (reference base_pdcnet.py:645-700) --
    def _direct(self, source, target, output_shape):
        h, w = target.shape[:2]
        ph, pw = _preprocess_shapes(h, w)
        src = resize_area(_nchw(self._image(source)[None]), (ph, pw))
        tgt = resize_area(_nchw(self._image(target)[None]), (ph, pw))
        if output_shape is None:
            output_shape = (h, w)
        ratio_x = float(w) / float(pw) * float(output_shape[1]) / float(w)
        ratio_y = float(h) / float(ph) * float(output_shape[0]) / float(h)
        flow, log_var, weight = self._forward(src, tgt, int(output_shape[0]),
                                              int(output_shape[1]))
        flow = flow * torch.tensor([ratio_x, ratio_y], dtype=torch.float32, device=self.device)
        uncertainty = {
            "log_var_map": log_var,
            "weight_map": weight,
            "p_r": p_r_of_mixture(weight, log_var, R=self.inference_parameters["R"], dim=-1),
            "variance": average_variance_of_mixture(weight, log_var, dim=-1),
            "inference_parameters": self.inference_parameters,
        }
        return flow, uncertainty

    def _compose_through_homography(self, source, target, H, mapping_h, output_shape):
        """The second pass of the 2-stage methods (reference
        base_pdcnet.py:262-298, 362-392): warp the source by H, estimate
        again and compose through the homography's mapping. Returns
        (flow_composed, mask, warping_mask, uncertainty); the callers keep
        the first-pass flow outside the masks."""
        h, w = target.shape[:2]
        src_warped = warp_perspective(self._image(source), H, (w, h))
        flow_second, uncertainty = self._direct(src_warped, target, output_shape)
        mapping_final = _warp_nhwc(mapping_h, flow_second)
        flow_composed = mapping_final - _grid_nhwc(mapping_final)
        ones = torch.ones((1,) + tuple(output_shape) + (1,), device=self.device)
        mask = _warp_nhwc(ones, flow_second)[..., 0] >= 0.98
        warping_mask = _sample_by_mapping_nhwc(ones, mapping_h)[..., 0] >= 0.98
        if self.inference_parameters["homography_visibility_mask"]:
            mask = mask & warping_mask
        uncertainty["warping_mask"] = mask
        return flow_composed, mask, warping_mask, uncertainty

    # -- 2-stage homography alignment (reference base_pdcnet.py:215-309) --
    def _with_homo(self, source, target, output_shape, scaling=0.25):
        h, w = target.shape[:2]
        if output_shape is None:
            output_shape = (h, w)
        inter_shape = (int(h * scaling), int(w * scaling))
        flow_est, uncertainty = self._direct(source, target, inter_shape)

        mask_pre = estimate_mask(self.inference_parameters["mask_type"], uncertainty,
                                 R=self.inference_parameters["R"])
        H, mapping_h = estimate_homography_and_correspondence_map(
            flow_est, mask_pre, original_shape=(h, w), mapping_output_shape=output_shape,
            scaling=np.float32([w, h]) / np.float32([inter_shape[1], inter_shape[0]]),
            ransac_thresh=self.inference_parameters["ransac_thresh"], min_nbr_points=200)
        if mapping_h is None:
            if tuple(inter_shape) != tuple(output_shape):
                flow_est, uncertainty = self._direct(source, target, output_shape)
            return flow_est, uncertainty

        flow_first = self._resize_and_rescale_flow(flow_est, output_shape)
        flow_composed, mask, warping_mask, uncertainty = self._compose_through_homography(
            source, target, H, mapping_h, output_shape)
        keep = (mask & warping_mask)[..., None]
        flow_out = torch.where(keep, flow_composed * mask[..., None] * warping_mask[..., None],
                               flow_first)
        return flow_out.float(), uncertainty

    # -- multiscale homography alignment (reference base_pdcnet.py:311-516) --
    def _homo_through_multiscale(self, source, target, inter_scaling, output_shape):
        """reference estimate_homo_through_multiscale (base_pdcnet.py:394-516):
        a RANSAC homography from each resizing ratio's confident
        quarter-resolution matches; the one with the highest normalized
        inlier fraction wins. Returns (H at image scale, mapping (1, out_h,
        out_w, 2) or None, the ratio-1 first-pass flow). One network pass
        per candidate, as in the JAX package."""
        p = self.inference_parameters
        ratio_list = list(p["list_resizing_ratios"])
        src, tgt = self._image(source), self._image(target)
        h_t, w_t = tgt.shape[:2]
        h_s, w_s = src.shape[:2]
        inter_shape = (int(h_t * inter_scaling), int(w_t * inter_scaling))
        # first dim horizontal then vertical (reference base_pdcnet.py:412)
        scaling = np.float32([w_t, h_t]) / np.float32([inter_shape[1], inter_shape[0]])
        if 1.0 not in ratio_list:
            ratio_list.append(1.0)
        idx_orig = ratio_list.index(1.0)
        norm_orig = float(h_t * w_t / scaling[0] * scaling[1])

        candidates = []  # (H_target, H_source, normalization, source, target)
        for ratio in ratio_list:
            if ratio == 1.0:
                candidates.append((np.eye(3), np.eye(3), norm_orig, src, tgt))
            elif ratio < 1.0:
                hr, wr = int(h_t * ratio), int(w_t * ratio)
                Ht = np.diag([wr / float(w_t), hr / float(h_t), 1.0])
                tgt_r = pad_to_size(warp_perspective(tgt, Ht, (wr, hr)), (h_t, w_t))
                candidates.append(
                    (Ht, np.eye(3), float(wr * hr / scaling[0] * scaling[1]), src, tgt_r))
            else:
                r = 1.0 / ratio
                hr, wr = int(h_s * r), int(w_s * r)
                Hs = np.diag([wr / float(w_s), hr / float(h_s), 1.0])
                src_r = pad_to_size(warp_perspective(src, Hs, (wr, hr)), (h_t, w_t))
                candidates.append((np.eye(3), Hs, norm_orig, src_r, tgt))

        flow_first = None
        hs, inlier_fracs = [], []
        for i, (Ht, Hs, normv, s_i, t_i) in enumerate(candidates):
            flow_i, unc_i = self._direct(s_i, t_i, inter_shape)
            if i == idx_orig:
                flow_first = flow_i
            mask_i = estimate_mask(p["mask_type"], unc_i, R=p["R"])
            H, inliers = estimate_homography_and_inliers(
                flow_i, mask_i, scaling=scaling, min_nbr_points=p["min_nbr_points_for_multi_scale"])
            if H is not None:
                hs.append(np.linalg.inv(Ht) @ H @ Hs)
                inlier_fracs.append(float(inliers) / normv)
            else:
                hs.append(np.eye(3))
                inlier_fracs.append(0.0)

        best = int(np.argmax(inlier_fracs))
        H_final = None
        if inlier_fracs[best] * 100.0 > p["min_inlier_threshold_for_multi_scale"]:
            H_final = hs[best]
        if H_final is None or np.all(H_final == np.eye(3)):
            return None, None, flow_first

        mapping = from_homography_to_pixel_wise_mapping((h_t, w_t), np.linalg.inv(H_final),
                                                        self.device)[None]
        oh, ow = output_shape
        if (oh, ow) != (h_t, w_t):
            # absolute pixel coords rescale with the resize (reference :510-513)
            scale = torch.tensor([ow / float(w_t), oh / float(h_t)], dtype=torch.float32,
                                 device=self.device)
            mapping = _resize_nhwc(mapping, (oh, ow)) * scale
        return H_final, mapping, flow_first

    def _with_multiscale(self, source, target, output_shape, inter_scaling=0.25):
        """reference estimate_flow_and_confidence_map_with_multiscale
        (base_pdcnet.py:311-392)."""
        h, w = target.shape[:2]
        if output_shape is None:
            output_shape = (h, w)
        H_img, mapping_h, flow_first = self._homo_through_multiscale(
            source, target, inter_scaling, output_shape)
        if mapping_h is None:
            return self._direct(source, target, output_shape)

        flow_first = self._resize_and_rescale_flow(flow_first, output_shape)
        flow_composed, mask, warping_mask, uncertainty = self._compose_through_homography(
            source, target, H_img, mapping_h, output_shape)
        keep = mask & warping_mask
        flow_out = (flow_composed * mask[..., None] * warping_mask[..., None]
                    + flow_first * (~keep)[..., None])
        return flow_out.float(), uncertainty

    @staticmethod
    def _resize_and_rescale_flow(flow, output_shape):
        """reference base_matching_net.py:181-192."""
        h, w = flow.shape[1:3]
        nh, nw = output_shape
        if (h, w) == (nh, nw):
            return flow
        scale = torch.tensor([float(nw) / w, float(nh) / h], dtype=torch.float32,
                             device=flow.device)
        return _resize_nhwc(flow, (nh, nw)) * scale

    def estimate_flow_and_confidence_map_(self, source, target, output_shape=None, scaling=1.0):
        mode = self.inference_parameters["multi_stage_type"].lower()
        if output_shape is None and scaling != 1.0:
            h, w = target.shape[:2]
            output_shape = (int(h * scaling), int(w * scaling))
        if mode in ("direct", "d"):
            return self._direct(source, target, output_shape)
        if mode in ("homography_from_quarter_resolution_uncertainty", "h"):
            return self._with_homo(source, target, output_shape, scaling=0.25)
        if mode in ("multiscale_homo_from_quarter_resolution_uncertainty", "ms"):
            return self._with_multiscale(source, target, output_shape, inter_scaling=0.25)
        raise NotImplementedError(f"multi_stage_type {mode}")

    def estimate_flow_and_confidence_map(self, source, target, output_shape=None, scaling=1.0):
        """Forward and, for the cyclic consistency error, backward estimate
        (reference base_pdcnet.py:144-180)."""
        flow, uncertainty = self.estimate_flow_and_confidence_map_(
            source, target, output_shape, scaling)
        if self.inference_parameters["compute_cyclic_consistency_error"]:
            flow_bwd, _ = self.estimate_flow_and_confidence_map_(
                target, source, output_shape, scaling)
            err = torch.linalg.norm(flow + _warp_nhwc(flow_bwd, flow), dim=-1, keepdim=True)
            uncertainty["cyclic_consistency_error"] = err
            uncertainty["inv_cyclic_consistency_error"] = 1.0 / (1.0 + err)
        return flow, uncertainty

    def get_matches_and_confidence(self, ref_image, src_image, scaling=0.25,
                                   confident_mask_type="proba_interval_1_above_10",
                                   min_number_of_pts=200):
        """reference base_pdcnet.py:518-570. ref/src: (H, W, 3) in [0, 255].
        Returns {kp_source, kp_target, confidence_value} (float32 numpy,
        by decreasing confidence; equal confidences keep their row-major
        order: a stable sort), flow and mask (numpy). kp_target indexes
        ref_image (the flow's frame), kp_source src_image."""
        flow, uncertainty = self.estimate_flow_and_confidence_map(
            src_image, ref_image, scaling=scaling)
        mask = estimate_mask(confident_mask_type, uncertainty, R=self.inference_parameters["R"])
        if "warping_mask" in uncertainty:
            mask = mask & uncertainty["warping_mask"]
        mapping = flow + _grid_nhwc(flow)
        mask = (mask & (mapping[..., 0] >= 0) & (mapping[..., 1] >= 0)
                & (mapping[..., 0] <= src_image.shape[1] * scaling - 1)
                & (mapping[..., 1] <= src_image.shape[0] * scaling - 1))
        scaling_kp = np.float32(ref_image.shape[:2]) / np.float32(flow.shape[1:3])
        mkpts_s, mkpts_t = matches_from_flow(flow, mask, scaling=scaling_kp[::-1])
        confidence = uncertainty["p_r"][..., 0][mask]
        order = torch.sort(-confidence, stable=True).indices
        mkpts_s, mkpts_t, confidence = mkpts_s[order], mkpts_t[order], confidence[order]
        if len(mkpts_s) < min_number_of_pts:
            mkpts_s = mkpts_t = flow.new_zeros(0, 2)
            confidence = flow.new_zeros(0)
        return {
            "kp_source": mkpts_s.float().cpu().numpy(),
            "kp_target": mkpts_t.float().cpu().numpy(),
            "confidence_value": confidence.float().cpu().numpy(),
            "flow": flow.cpu().numpy(),
            "mask": mask.cpu().numpy(),
        }
