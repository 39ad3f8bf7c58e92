"""The benchmark's cells cut to sizes a CPU test can hold."""

import time

import torch

from perfbench import core

SEED = 2**31 + 12345


def context(name: str, seconds: float = 1.0, seed: int = SEED, bench=None) -> core.Context:
    bench = bench or core.load_benchmark()
    cell, config, traffic = core.load_cell(bench, name)
    config = {**config, "width": 16, "height": 12, "max_bounces": 3}
    if config["scene"] == "hero":
        config["scene_args"] = {"num_triangles": 20_000, "seed": 7}
    traffic = {**traffic, "check_pixels": 24, "check_batch": 4096, "warmup_frames": 3,
               "block": 10, "check_block": 20, "samples": 4, "warmup_samples": 2}
    if traffic["driver"] == "offline":
        config.update(min_samples=4, max_samples=40)
        seconds = max(seconds, 4.0)
    return core.Context(cell, config, traffic, seed, seconds, False, torch.device("cpu"))


def run(name: str, **kwargs):
    """(result dict, checks) of a tiny CPU run of cell ``name``."""
    bench = core.load_benchmark()
    ctx = context(name, bench=bench, **kwargs)
    return core.run(ctx, bench, time.perf_counter())
