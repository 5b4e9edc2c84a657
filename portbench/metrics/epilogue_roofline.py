"""Conv epilogue kernel (kernels/epilogue.py, `conv_epilogue_kernel`): the
least time of a forward's conv epilogues over the kernel's device time a
forward in the profiled stretch, in %.

The work is counted on the reference model at the cell's batch and size:
every eval conv with a BatchNorm or a bias after it whose epilogue no
other kernel of the port fuses (the YOLOv3 model's 72 conv-BN-leaky
convs and its 3 output convs; ResNet-50's conv-BN convs outside the six
blocks the fused bottleneck computes whole). Each reads its N outputs
and writes N, and reads N more where a residual joins (Darknet's
residual blocks, a bottleneck's last conv), in the configuration's
dtype, over the HBM rate. The calls a forward are the convs counted."""
from types import ModuleType

import torch

from portbench import yardstick
from portbench.reference import darknet, layers, resnet, yolov3

NAME, UNIT, KIND, SOURCE = "epilogue_roofline", "%", "detect", "device_trace"
LAYER, MOVES = "kernels", "detect_img_s"
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def _fused(stage: int, block: int) -> bool:
    """ResNet-50's blocks the fused bottleneck computes: all of stage 0,
    stage 1 from block 1 on (`yardstick.resnet_fused_blocks`)."""
    return stage == 0 or (stage == 1 and block >= 1)


def epilogue_convs(family: ModuleType, num_classes: int, batch: int,
                   size: int) -> list[tuple[int, bool]]:
    """(output elements, whether a residual joins) of each conv whose
    epilogue the kernel computes, from a forward of `family`'s reference
    on the meta device."""
    with torch.device("meta"):
        model = family.build(num_classes).eval()
    residual, skip = set(), set()
    for m in model.modules():
        if isinstance(m, darknet.ResBlock):
            residual.add(id(m.conv2))
        elif isinstance(m, resnet.Bottleneck):
            residual.add(id(m.conv3))
        elif isinstance(m, resnet.ResNet):
            for si in range(len(resnet.STAGE_CHANNELS)):
                for bi, block in enumerate(getattr(m, f"stage{si}").children()):
                    if _fused(si, bi):
                        skip.update(id(c) for c in block.modules())
    found, hooks = [], []
    for m in model.modules():
        if id(m) in skip:
            continue
        if isinstance(m, (layers.ConvBN, layers.ConvBNLeaky, yolov3.Branch)):
            joins = id(m) in residual
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, joins=joins:
                    found.append((out.numel(), joins))))
    images = torch.zeros((batch, size, size, 3), dtype=torch.uint8,
                         device="meta")
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    return found


def bound_ms(convs, elem_bytes: int) -> float:
    """Least time of these epilogues: 2·N (+ N with a residual) elements
    moved each, over the HBM rate."""
    moved = sum(n * (3 if joins else 2) for n, joins in convs)
    return yardstick.least_ms(moved * elem_bytes, 0, yardstick.BF16_FLOPS)


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    secs, launches = yardstick.kernel_seconds(trace, "conv_epilogue")
    if not launches:
        return None
    cfg = ctx["config"]
    convs = epilogue_convs(ctx["family"], cfg["num_classes"], ctx["batch"],
                           cfg["input_size"])
    forward_ms = secs * 1e3 * len(convs) / launches
    return 100.0 * bound_ms(convs, ELEM_BYTES[cfg["dtype"]]) / forward_ms
