"""Share of a detect step in which no kernel or copy runs on the device, in %:
one less the device's busy time a step (the union of the device intervals
in the profiled stretch, over its steps) over the step's wall time before
the stretch. The profiler's tracing of the CUDA runtime slows a host-bound
loop, so the stretch's own idle share reads high; the device's busy time
a step does not move with it."""
NAME, UNIT, KIND, SOURCE = "device_idle.detect", "%", "detect", "device_trace"
LAYER, MOVES = "device", "detect_img_s"


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("profiled_steps")
    if trace is None or not steps or not trace["busy_s"]:
        return None
    step_s = ctx["batch"] / ctx["rate"]
    return 100.0 * (1.0 - trace["busy_s"] / steps / step_s)
