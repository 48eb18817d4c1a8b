"""R007 violations: broad handlers that swallow."""


def run(fn, log):
    try:
        fn()
    except Exception as e:                     # R007
        log.append(e)
    try:
        fn()
    except:                                    # noqa: E722  R007
        pass
