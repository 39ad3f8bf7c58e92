"""CUDA records the card ran per train step in the traced window."""


def read(summary):
    if summary.kind != "train" or summary.steps <= 0:
        return None
    return len(summary.records) / summary.steps
