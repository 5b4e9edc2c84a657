"""Plain float32 PyTorch references of the benchmarked models.

A frozen copy of the detection port's plain model code (YOLOv3 with
Darknet-53, FCOS with ResNet-50-FPN and GroupNorm towers), its decode,
postprocess and losses, and plain SGD. Nothing here imports the port
or JAX: the benchmark's `correct` holds the port against this code,
which later changes to the port do not touch. Parameter names follow
the port's modules, so one state dict loads into both.
"""
