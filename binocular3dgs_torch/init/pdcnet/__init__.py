"""PDCNet+ dense matcher, the port of `binocular3dgs_tpu/init/pdcnet/`.

  layers.py      conv block, l2norm, resizes, grid sample, flow warp (torch's own)
  vgg.py         VGG-16 feature pyramids
  gocor.py       Global and Local GOCor unrolled optimizers
  decoders.py    mapping/flow decoders and PWC refinement
  uncertainty.py mixture-density heads and P_R
  model.py       PDCNetModel, the 4-level forward; `random_model` for checks
  homography.py  RANSAC homography and perspective warp (OpenCV's semantics)
  inference.py   PDCNetPlus: pre-processing, direct / homography / multiscale
                 estimation, cyclic consistency, matches
  convert.py     weights between the reference checkpoint, the port and the
                 JAX package's npz

The state_dict names are the reference's (and the JAX package's param
names); the network runs NCHW, the inference's maps are NHWC as in the JAX
package. No trained checkpoint is in the repository.
"""

from .inference import PDCNetPlus  # noqa: F401
