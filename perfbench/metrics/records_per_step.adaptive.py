"""CUDA records the card ran per step of a traced offline render window (a
full or a tail step of the adaptive loop). It moves
``rays_per_s.adaptive``."""


def read(summary):
    if summary.kind != "render" or summary.steps <= 0:
        return None
    return len(summary.records) / summary.steps
