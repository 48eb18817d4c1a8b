"""R007 conforming: re-raise, resolve the future, or narrow."""


def run(fn, fut):
    try:
        fn()
    except Exception as e:
        fut.set_exception(e)
    try:
        fn()
    except Exception:
        raise
    try:
        fn()
    except ValueError:
        pass
