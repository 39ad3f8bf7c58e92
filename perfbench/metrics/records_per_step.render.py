"""CUDA records the card ran per render step (a frame, a full or a tail
step) in the traced window."""


def read(summary):
    if summary.kind != "render" or summary.steps <= 0:
        return None
    return len(summary.records) / summary.steps
