"""R004 suppressed inline, with its reason."""


def register(name):
    return lambda cls: cls


@register("sketch")
class Sketch:  # repro: allow[R004] a registry test's stand-in
    def prepare(self, A, prm):
        return A
