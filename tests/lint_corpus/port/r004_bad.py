"""R004 violations: a lifecycle hook missing, a partial mesh surface, a
redundant claim without its hooks."""


def register(name):
    return lambda cls: cls


class StubBase:
    def prepare(self, A, prm):
        raise NotImplementedError

    def mesh_placements(self):
        raise NotImplementedError

    def mesh_factors(self, factors):
        return factors

    def mesh_init(self, factors, b, prm, ctx):
        return None

    def red_factors(self, factors, assign):
        return factors

    def red_step(self, factors, b, state, prm, W, ctx):
        raise NotImplementedError


@register("half_baked")
class HalfBaked(StubBase):                   # R004: no extract
    def prepare(self, A, prm):
        return A

    def init(self, f, b, prm):
        return b

    def step(self, f, b, s, prm):
        return s


@register("mesh_partial")
class MeshPartial(HalfBaked):              # R004: mesh_step only
    def extract(self, s):
        return s

    def mesh_step(self, f, b, s, prm, ctx):
        return s


@register("red_partial")
class RedPartial(MeshPartial):             # R004: no red_step, red_init
    supports_redundancy = True

    def mesh_placements(self):
        return None

    def mesh_prepare(self, A, prm, ctx):
        return A
