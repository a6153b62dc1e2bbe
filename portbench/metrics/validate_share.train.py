"""Share (%) of the untraced window spent in the epochs' validation
(``Trainer.history``'s ``validate_s``)."""


def read(r):
    if not r.extra.get("window_s"):
        return None
    return r.extra["validate_s"] / r.extra["window_s"] * 100.0
