"""Hand-written CUDA kernels of the port and their plain versions.

Every wrapper here counts its launches in a `launches` attribute;
`KERNELS` lists them so a run can reset and read every count. The seven
forward kernels of the detect path launch through custom ops
(`kernels.ops`, registered on import), so exported programs launch
them too. `plain_versions()` routes every call site to the plain
versions instead (`Detector(use_pallas=False)`).
"""

from mydetection_tpu_torch.kernels import ops  # noqa: F401  registers mydet::
from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck
from mydetection_tpu_torch.kernels.epilogue import conv_epilogue
from mydetection_tpu_torch.kernels.gather import gather_rows
from mydetection_tpu_torch.kernels.gn import (
    bias_gn_relu,
    bias_gn_relu_bwd,
    bias_gn_relu_fwd_stats,
)
from mydetection_tpu_torch.kernels.nms import nms_keep
from mydetection_tpu_torch.kernels.rotated_nms import nms_from_iou_keep
from mydetection_tpu_torch.kernels.route import (
    kernels_enabled,
    plain_versions,
)
from mydetection_tpu_torch.kernels.tower import conv3x3_chain

KERNELS = (nms_keep, bias_gn_relu, nms_from_iou_keep, bias_gn_relu_fwd_stats,
           bias_gn_relu_bwd, conv3x3_chain, gather_rows, fused_bottleneck,
           conv_epilogue)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
