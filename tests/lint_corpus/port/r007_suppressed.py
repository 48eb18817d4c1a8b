"""R007 suppressed inline, with its reason."""


def best_effort(fn):
    try:
        fn()
    except Exception:  # repro: allow[R007] cleanup only, nothing pending
        pass
