"""Seconds of ``Evaluation.save_results`` a subject (the maps' gzip and
write), from the benchmark's span around it: the traced window's total
over the subjects written."""


def read(run):
    spans = run.in_window('save_results')
    return sum(s['t1'] - s['t0'] for s in spans) / run.count \
        if spans and run.count else None
