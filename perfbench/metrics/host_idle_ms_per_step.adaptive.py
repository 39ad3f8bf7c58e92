"""Device-idle time under the program's spans, in ms a render step (a full
or a tail step of the adaptive loop) of a traced offline render window:
``host_idle_ms_per_step.render``'s measure, loaded from its file. It moves
``rays_per_s.adaptive``."""

import importlib.util
from pathlib import Path


def _measure():
    path = Path(__file__).with_name("host_idle_ms_per_step.render.py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_host_idle_ns", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.host_idle_ns


def read(summary):
    if summary.kind != "render" or summary.steps <= 0 or not summary.records:
        return None
    ns = _measure()(summary)
    return None if ns is None else ns * 1e-6 / summary.steps
