"""R004 conforming: the lifecycle, the mesh and the redundant surfaces
whole (the base's defaults count)."""


def register(name):
    return lambda cls: cls


class HookDefaults:
    def mesh_factors(self, factors):
        return factors

    def mesh_init(self, factors, b, prm, ctx):
        return None

    def red_factors(self, factors, assign):
        return factors

    def red_expand(self, state, assign):
        return state

    def red_collapse(self, state, assign):
        return state

    def red_factor_placements(self, fpl):
        return fpl

    def red_state_placements(self, spl):
        return spl


@register("whole")
class Whole(HookDefaults):
    supports_redundancy = True

    def prepare(self, A, prm):
        return A

    def init(self, f, b, prm):
        return b

    def step(self, f, b, s, prm):
        return s

    def extract(self, s):
        return s

    def mesh_placements(self):
        return None

    def mesh_prepare(self, A, prm, ctx):
        return A

    def mesh_step(self, f, b, s, prm, ctx):
        return s

    def red_init(self, f, b, prm, W, ctx):
        return b

    def red_step(self, f, b, s, prm, W, ctx):
        return s
