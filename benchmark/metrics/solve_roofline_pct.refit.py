"""The solve's share of its roofline, in percent: the least time of the
window's solves (``portbench/work.py``: the larger of the least bytes over
3.35 TB/s and the least operations over 67 TFLOP/s float32, H100 SXM)
over the device time of the kernels launched inside the program's ``fit``
ranges, copies excluded (from the profiler's trace)."""


def read(run):
    s = run.summary
    if not s or not s.get('fit_kernel_s') or not run.least_s:
        return None
    return 100.0 * run.least_s / s['fit_kernel_s']
