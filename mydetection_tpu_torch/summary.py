"""Model summary CLI: parameter counts and forward FLOPs.

    python -m mydetection_tpu_torch.summary yolov3 [--input-size 416]

The port of `mydetection_tpu/summary.py`: parameters by top-level module
(the JAX tree's top-level keys: the port's modules carry its names) and
in total, BN running statistics included as the JAX trees carry them,
and the float32 dense forward's GFLOPs per image from
`utils.flops.compiled_flops` (convolutions and matrix products, the
card's fused conv kernels counted as the convolutions they fuse). Handy
when checking that an imported checkpoint or a config override
reproduces the reference geometry. `--device` defaults to cuda, as the
other CLIs do; `--device cpu` counts on the CPU (the same numbers).
"""

from __future__ import annotations

import argparse
from collections import Counter

import torch


def summarize(name: str, *, input_size: int | None = None, batch: int = 1,
              device: str | torch.device | None = None,
              use_pallas: bool | None = None) -> dict:
    """{model, input_size, num_classes, params, params_by_module,
    gflops_per_image} for the registered model `name`, counted on
    `device` (None: cuda). use_pallas=False runs every kernel's plain
    version instead (the FLOP count does not change)."""
    from mydetection_tpu_torch.kernels import plain_versions
    from mydetection_tpu_torch.registry import forward_dense, get_model
    from mydetection_tpu_torch.utils.flops import compiled_flops

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("summary runs on CUDA by default and no GPU is "
                           "visible; pass device='cpu' (--device cpu)")
    overrides = {"compute_dtype": torch.float32}
    if input_size:
        overrides["input_size"] = input_size
    model = get_model(name, **overrides).eval().requires_grad_(False)
    model = model.to(device)
    if device.type == "cuda":   # the kernels read NHWC, as in Detector
        model = model.to(memory_format=torch.channels_last)
    cfg = model.config
    per_module = Counter()
    for key, t in model.state_dict().items():
        per_module[key.split(".")[0]] += t.numel()
    x = torch.zeros((batch, cfg.input_size, cfg.input_size, 3),
                    dtype=torch.uint8, device=device)
    with plain_versions(use_pallas is False):
        fl = compiled_flops(forward_dense, model, x)
    return {
        "model": cfg.name,
        "input_size": cfg.input_size,
        "num_classes": cfg.num_classes,
        "params": sum(per_module.values()),
        "params_by_module": dict(per_module),
        "gflops_per_image": fl / batch / 1e9 if fl else None,
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model", nargs="?", default="yolov3")
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    info = summarize(args.model, input_size=args.input_size,
                     device=args.device)
    print(f"{info['model']} @ {info['input_size']}  "
          f"(classes={info['num_classes']})")
    for k, v in sorted(info["params_by_module"].items()):
        print(f"  {k:>10}: {v / 1e6:8.2f} M params")
    print(f"  {'total':>10}: {info['params'] / 1e6:8.2f} M params")
    if info["gflops_per_image"] is not None:
        print(f"  forward: {info['gflops_per_image']:.2f} GFLOPs/image "
              f"(FlopCounterMode, float32 dense forward incl. decode)")
    return info


if __name__ == "__main__":
    main()
