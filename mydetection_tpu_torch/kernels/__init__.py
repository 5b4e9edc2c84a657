"""Hand-written CUDA kernels of the port and their plain versions.

Every wrapper here counts its launches in a `launches` attribute;
`KERNELS` lists them so a run can reset and read every count.
"""

from mydetection_tpu_torch.kernels.gn import bias_gn_relu
from mydetection_tpu_torch.kernels.nms import nms_keep
from mydetection_tpu_torch.kernels.rotated_nms import nms_from_iou_keep

KERNELS = (nms_keep, bias_gn_relu, nms_from_iou_keep)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
