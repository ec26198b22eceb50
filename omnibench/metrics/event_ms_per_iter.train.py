"""Host ms of the training loop's event iterations (`Trainer.train_iteration`
when `train_window` returns 0: densify, reset) an iteration of the window:
the host clock around each such call, from a synchronise to a
synchronise, summed, over all the window's iterations."""


def read(trace):
    if not trace or trace.get("kind") != "train" or not trace.get("window_iters"):
        return None
    return 1e3 * trace["event_s"] / trace["window_iters"]
