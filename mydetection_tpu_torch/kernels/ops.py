"""The forward kernels of the detect path as PyTorch custom ops.

Each op's CUDA implementation is its wrapper module's `*_launch`
function: the `ctypes` launch of the kernel, which reads `data_ptr()`,
picks the launch plan and counts the launch. Its fake implementation
gives the output's shape, dtype and memory layout from the inputs'
alone, so `torch.export` and `FlopCounterMode` trace through the op
without a card, and an exported program calls the same op, and so the
same kernel, as the eager wrappers do. The wrappers (`nms_keep`, ...)
call these ops on CUDA tensors and their plain versions on CPU tensors.

    mydet::nms_keep            kernel #1, csrc/nms.cu
    mydet::nms_from_iou_keep   kernel #2, csrc/rotated_nms.cu
    mydet::bias_gn_relu        kernel #3, csrc/gn.cu (the forward)
    mydet::conv3x3_chain       kernel #6, csrc/tower.cu
    mydet::fused_bottleneck    kernel #7, csrc/bottleneck.cu
    mydet::gather_rows         kernel #8, csrc/gather.cu
    mydet::conv_epilogue       a conv's eval epilogue, csrc/epilogue.cu
                               (no TPU counterpart)

The training kernels (#4, #5) stay `torch.autograd.Function`s
(`gn.BiasGNReLU`): no exported or served program runs them. #6 and #7
count, in `torch.utils.flop_counter`, the FLOPs of the convolutions
they fuse, so a FLOP count reads the same work with or without them.
Importing this module registers the ops once per process.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from mydetection_tpu_torch.kernels import (
    bottleneck,
    epilogue,
    gather,
    gn,
    nms,
    rotated_nms,
    tower,
)

NAMESPACE = "mydet"

# name → (schema, CUDA implementation, fake implementation)
_OPS = {
    "nms_keep": ("(Tensor boxes, Tensor valid, float iou_thres) -> Tensor",
                 nms.nms_keep_launch, nms.nms_keep_fake),
    "nms_from_iou_keep": (
        "(Tensor iou, Tensor valid, float iou_thres) -> Tensor",
        rotated_nms.nms_from_iou_keep_launch,
        rotated_nms.nms_from_iou_keep_fake),
    "bias_gn_relu": ("(Tensor x, Tensor bias, Tensor scale, Tensor shift, "
                     "int groups) -> Tensor",
                     gn.bias_gn_relu_launch, gn.bias_gn_relu_fake),
    "conv3x3_chain": ("(Tensor x, Tensor packed, Tensor biases) -> Tensor",
                      tower.conv3x3_chain_launch, tower.conv3x3_chain_fake),
    "fused_bottleneck": (
        "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
        "Tensor b3, Tensor? wd=None, Tensor? bd=None) -> Tensor",
        bottleneck.fused_bottleneck_launch, bottleneck.fused_bottleneck_fake),
    "gather_rows": ("(Tensor src, Tensor sel) -> Tensor",
                    gather.gather_rows_launch, gather.gather_rows_fake),
    "conv_epilogue": (
        "(Tensor x, Tensor? scale, Tensor bias, Tensor? mean, Tensor? var, "
        "Tensor? residual, int act, bool residual_after) -> Tensor",
        epilogue.conv_epilogue_launch, epilogue.conv_epilogue_fake),
}

OP_NAMES = tuple(f"{NAMESPACE}::{name}" for name in _OPS)


def _register() -> None:
    for name, (schema, launch, fake) in _OPS.items():
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", launch,
                                     mutates_args=(), device_types="cuda",
                                     schema=schema)
        op.register_fake(fake)


_register()


@register_flop_formula(torch.ops.mydet.conv3x3_chain)
def _chain_flops(x_shape, packed_shape, biases_shape, *args, out_shape=None,
                 **kwargs) -> int:
    return tower.conv3x3_chain_flops(x_shape, packed_shape)


@register_flop_formula(torch.ops.mydet.fused_bottleneck)
def _bottleneck_flops(x_shape, w1_shape, b1_shape, w2_shape, b2_shape,
                      w3_shape, b3_shape, wd_shape=None, bd_shape=None, *,
                      out_shape=None, **kwargs) -> int:
    return bottleneck.fused_bottleneck_flops(x_shape, w1_shape, w2_shape,
                                             w3_shape, wd_shape)


def ops_in(program) -> list[str]:
    """The `mydet::` ops an exported program's graph calls, sorted."""
    found = set()
    for node in program.graph.nodes:
        target = node.target
        if node.op == "call_function" and hasattr(target, "namespace") \
                and target.namespace == NAMESPACE:
            found.add(f"{NAMESPACE}::{target._opname}")
    return sorted(found)
