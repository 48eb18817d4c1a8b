"""Roofline analysis of a traced step, per device (the port's counterpart
of ``repro.launch.analysis``).

The reference walks the post-SPMD HLO of a compiled program, which is
the per-device program.  The port counts the same three things on the
torch program as it runs: :class:`Counter` is a ``TorchDispatchMode``
that lets every DTensor op desugar first (it returns ``NotImplemented``
to a DTensor, as torch's ``CommDebugMode`` does) and so sees the ops one
rank runs on its local shards, the collectives DTensor inserts
included.  It counts, per device:

* FLOPs: the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions: torch's own formulas, ``torch.utils.flop_counter``) from
  their local operand shapes; every other op as an elementwise one, by
  the larger of its output's and its largest input's element count, as
  the reference's walker does.  A view, an ``empty`` and a wait cost
  nothing.  ``torch.utils.flop_counter.FlopCounterMode`` on its own
  counts the global (DTensor) op: a (256, 4096) @ (4096, 4096) product
  with its weight split 16 ways counts 16x the device's work.
* HBM bytes: the operands and outputs of each local op; a gather or an
  index reads and writes its output's bytes, a scatter or a copy its
  source's, as the reference's walker counts slicing ops.
* Collective bytes by kind: the output of each ``_c10d_functional``
  all-gather, all-reduce, reduce-scatter or all-to-all (and of the c10d
  ops ``torch.distributed``'s calls dispatch), as reference ``:294-297``
  attributes them, split by link: a group whose ranks sit in one 8-card
  host moves over NVLink, any other over the hosts' network.

and a memory record: the step's argument bytes on the device, and the
peak of the live bytes (arguments plus every storage an op made that is
still referenced), which is held against the card's 80 GB.

Hardware constants: one NVIDIA H100 SXM5 (NVIDIA's H100 data sheet,
dense rates without sparsity, at the full 700 W power limit): 989e12
FLOP/s in bfloat16 and float16, 67e12 in float32 outside the tensor
cores (the port runs its float32 products with TF32 off) and 67e12 in
float64 (the FP64 tensor cores); 3.35e12 B/s of HBM3; NVLink 4 at 450e9
B/s each way per card inside one 8-card host (18 links of 25 GB/s each
way, NVIDIA's DGX H100); and 50e9 B/s per card between hosts (one 400
Gb/s ConnectX-7 NDR port per card, as in the DGX H100).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # bf16 dense per card
PEAK_BY_DTYPE = {torch.bfloat16: 989e12, torch.float16: 989e12,
                 torch.float32: 67e12, torch.float64: 67e12}
HBM_BW = 3.35e12             # bytes/s per card
HBM_BYTES = 80e9             # bytes per card
NVLINK_BW = 450e9            # bytes/s per card each way, inside a host
NETWORK_BW = 50e9            # bytes/s per card between hosts
HOST_CARDS = 8               # cards per host

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (without overload) -> collective kind; the functional
# collectives DTensor issues and the c10d ops torch.distributed's calls
# dispatch
_COLL_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
        "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_":
        "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
        "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "detach", "alias"}
_WINDOW_READS = {"index", "gather", "index_select", "embedding", "take"}
_WINDOW_WRITES = {"index_put", "index_put_", "scatter", "scatter_",
                  "scatter_add", "scatter_add_", "index_add", "index_add_",
                  "index_copy", "index_copy_", "slice_scatter",
                  "select_scatter", "copy_", "_index_put_impl_"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(args) -> Optional[list]:
    """The ranks of a collective's group, from its group name (functional
    collectives) or its ProcessGroup argument (c10d ops)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        try:
            if isinstance(a, str):
                return dist.get_process_group_ranks(
                    c10d._resolve_process_group(a))
            if isinstance(a, torch.ScriptObject):      # a boxed group
                a = dist.ProcessGroup.unbox(a)
            if isinstance(a, dist.ProcessGroup):
                return dist.get_process_group_ranks(a)
        except (ValueError, RuntimeError, KeyError, AttributeError,
                TypeError):
            continue
    return None


@dataclasses.dataclass
class Cost:
    """What one device did: FLOPs (and the seconds they take at each
    dtype's peak), HBM bytes, collective bytes by kind and by link."""
    flops: float = 0.0
    compute_s: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_nvlink: float = 0.0
    coll_network: float = 0.0

    def coll_total(self) -> float:
        return float(sum(self.coll.values()))

    @property
    def collective_s(self) -> float:
        return self.coll_nvlink / NVLINK_BW + self.coll_network / NETWORK_BW


class Counter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes and collectives, and its live
    memory, over the ops run inside it (module docstring).  ``args``: the
    step's arguments (trees of tensors or DTensors), whose local bytes
    are the baseline of the memory record."""

    def __init__(self, args=(), count: bool = True):
        super().__init__()
        self.cost = Cost()
        self.count = count
        self._live: Dict[int, list] = {}      # storage key -> [bytes, refs]
        self.live_bytes = 0
        self.argument_bytes = 0
        # the arguments' local tensors, held: they stay live all through
        self._held = [t.to_local() if _is_dtensor(t) else t
                      for t in _tensors(args)]
        for local in self._held:
            if self._track(local):
                self.argument_bytes += _nbytes(local)
        self.peak_bytes = self.live_bytes

    # ---- memory ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> bool:
        """Register ``t``'s storage; True where it is a new one."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return False
        key = st._cdata
        entry = self._live.get(key)
        new = entry is None
        if new:
            entry = self._live[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
        entry[1] += 1
        weakref.finalize(t, self._release, key)
        return new

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    # ---- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented     # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, out))):
            # DTensor deriving an output's global shape on fake tensors:
            # no rank runs this op
            return out
        if isinstance(func, torch._ops.OpOverload):
            for t in _tensors(out):
                self._track(t)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            if self.count:
                self._cost(func, args, kwargs, out)
        return out

    def _cost(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        c = self.cost
        name = func.overloadpacket.__name__
        kind = _COLL_OPS.get(name)
        outs = [t for t in _tensors(out)]
        ins = [t for t in _tensors(args)] + [t for t in _tensors(kwargs)]
        if kind is not None:
            moved = sum(_nbytes(t) for t in outs if t.numel())
            ranks = _group_ranks(args) or []
            if len(ranks) > 1:
                c.coll[kind] += moved
                c.bytes += moved
                hosts = {r // HOST_CARDS for r in ranks}
                if len(hosts) == 1:
                    c.coll_nvlink += moved
                else:
                    c.coll_network += moved
            return
        if name in _FREE or getattr(func, "is_view", False) or not outs:
            return
        dtype = outs[0].dtype
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            dtype = ins[0].dtype if ins else dtype
        else:
            flops = float(max([t.numel() for t in outs + ins] or [0]))
        c.flops += flops
        c.compute_s += flops / PEAK_BY_DTYPE.get(dtype, PEAK_FLOPS)
        if name in _WINDOW_READS:
            c.bytes += 2.0 * sum(_nbytes(t) for t in outs)
        elif name in _WINDOW_WRITES:
            src = ins[-1] if name in ("copy_",) else (
                ins[-1] if ins else outs[0])
            c.bytes += 2.0 * _nbytes(src)
        else:
            c.bytes += sum(_nbytes(t) for t in outs) + \
                sum(_nbytes(t) for t in ins)


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


# ---------------------------------------------------------------------------
# Roofline record
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Roofline:
    name: str
    mesh_shape: tuple
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float           # whole-program 6·N·D analytic useful work
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    compute_seconds: float = 0.0     # FLOPs at each dtype's peak
    collective_seconds: float = 0.0  # bytes at each group's link rate

    @property
    def chips(self) -> int:
        return int(math.prod(self.mesh_shape))

    @property
    def t_compute(self) -> float:
        return self.compute_seconds

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_seconds

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / the FLOPs all devices run (remat, redundant and
        wasted work lower it)."""
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The useful-FLOPs share of the bf16 peak that the dominant term
        allows (the others perfectly overlapped)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def row(self) -> dict:
        return {
            "name": self.name, "chips": self.chips,
            "flops_dev": self.flops_per_device,
            "hbm_bytes_dev": self.hbm_bytes_per_device,
            "coll_bytes_dev": self.collective_bytes_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counter(name, mesh_shape, counter: Counter,
                 model_flops) -> Roofline:
    c = counter.cost
    return Roofline(
        name=name, mesh_shape=tuple(mesh_shape),
        flops_per_device=c.flops, hbm_bytes_per_device=c.bytes,
        collective_bytes_per_device=c.coll_total(),
        model_flops=model_flops,
        collectives={k: v for k, v in c.coll.items() if v},
        compute_seconds=c.compute_s, collective_seconds=c.collective_s)


def memory_record(counter: Counter) -> dict:
    """The step's per-device memory: argument and peak bytes, and whether
    the peak fits the card."""
    return {"argument_bytes": counter.argument_bytes,
            "peak_bytes": counter.peak_bytes,
            "fits_80gb": counter.peak_bytes <= HBM_BYTES}
