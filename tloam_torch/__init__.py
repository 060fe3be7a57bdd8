"""tloam_torch — the PyTorch/CUDA port of ``tloam_tpu``.

The same truncated-least-squares LiDAR odometry front end, module for module
(``ops.se3``, ``cloud``, ``ops.eig3``, ``ops.voxel``, ``ops.residuals``,
``models.*``, ``pipeline.frontend``, ``parallel.*``), on PyTorch tensors,
with what a user runs around it: the ``tloam-torch`` command line
(``cli``, ``bench``), checkpoints (``utils.checkpoint``), KITTI and
point-cloud files (``io.*``), the Open3D-style cloud ops (``ops.cloud_ops``,
``ops.factories``) and the synthetic drives (``utils.drives``). The one TPU kernel
of the main path (the edge greedy-pick rounds, ``tloam_tpu/models/edge.py``)
is a hand-written CUDA kernel here (``csrc/edge_pick.cu``), built with nvcc
at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (``tloam_torch.device``).
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of tloam_tpu/__init__.py:45-48 ("highest" matmul precision):
# the solver's J^T J / J^T r reductions and the window-moment matmuls must
# stay in full float32, so TF32 is kept off for matmuls and convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
