"""Content-addressed factor store: cached one-time factorizations.

Counterpart of ``repro.solvers.store``.  The paper's cost split — an
expensive b-INDEPENDENT ``prepare`` (Gram Cholesky factors, the kernels'
pinv factors) followed by cheap per-RHS iterations — is what serve
traffic amortizes.  ``FactorStore`` is the one way a driver obtains
factors:

    store = FactorStore(capacity=8, directory="/ckpt/factors")
    factors = store.factors(solvers.get("apc"), sys, **params)
    store.stats            # hits / disk_hits / misses / evictions / ...

Systems are fingerprinted by a sha256 over the A-blocks' CONTENT, the
partition (m, p, n), the dtype, the solver name and the resolved
parameters (and, for a sparse system, its column support; for
``precision="mixed"``, the precision).  The digest is byte-identical to
the reference's for the same system, parameters and precision: the same
tokens in the same order, the dtype by its numpy name, ``cols`` hashed as
the reference's int32.

Three tiers:

  * memory — an LRU of factors on the system's device (``capacity``
    entries); a hit returns the SAME object;
  * disk (optional) — every miss is persisted in the checkpoint layout of
    ``repro_torch.checkpoint.ckpt`` (tmp dir -> leaf_*.npy + manifest.json
    + COMMIT marker -> atomic ``os.replace``), so factorizations survive
    restarts.  The manifest is validated on load (solver / structure /
    partition / dtype / leaf shapes) and drift fails LOUDLY.  A bfloat16
    leaf (a ``precision="mixed"`` entry) is stored as its bits;
  * blocks — per-row-block factorizations (``blockwise_factors``), reused
    across repartitions.

The manifest records the factor structure by the port's own NamedTuple
classes (``repro_torch.solvers.projection:ProjFactors``, ...), so the port
does not read a factor directory the reference wrote (nor the other way
round): an entry naming another package's classes is refused loudly.

Kernel path: ``factors(..., use_kernel=True)`` augments the cached entry
with the pinv factors ONCE (``Solver.kernel_factors`` is idempotent) and
writes the augmented factors back into the slot.  A ``precision="mixed"``
entry lives under its own fingerprint and is cast LAST: it stays bf16.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import logging
import os
from collections import OrderedDict
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import COMMIT
from repro_torch.core.partition import BlockSystem

log = logging.getLogger("repro_torch.solvers.store")

__all__ = ["BlockReuse", "FactorStore", "StoreStats", "block_fingerprint",
           "fingerprint"]


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _param_tokens(h, params: Dict[str, Any]) -> None:
    for k in sorted(params):
        try:
            # normalize numeric types: 1.3, np.float64(1.3) and a 0-d
            # tensor hash identically
            v = repr(float(params[k]))
        except (TypeError, ValueError):
            v = repr(params[k])
        h.update(f"param:{k}={v}".encode())


def fingerprint(solver_name: str, sys: BlockSystem,
                params: Dict[str, Any], precision: str = "default") -> str:
    """Content hash identifying (A-blocks, partition, solver, params).

    Everything ``prepare`` can depend on is in the digest; b is NOT — the
    factorization is b-independent, so one entry serves every right-hand
    side of the same system.  Sparse systems also hash their structure tag
    and column support (the reference's int32 ``cols``); a non-default
    ``precision`` enters last, so default digests are unchanged by it.
    """
    A = _host(sys.A_blocks)
    h = hashlib.sha256()
    h.update(f"solver={solver_name}".encode())
    h.update(f"partition={tuple(A.shape)}".encode())
    h.update(f"dtype={A.dtype}".encode())
    _param_tokens(h, params)
    h.update(memoryview(A).cast("B"))
    if sys.is_sparse:
        cols = _host(sys.cols).astype(np.int32)
        h.update(b"structure=sparse")
        h.update(f"support={tuple(cols.shape)}".encode())
        h.update(memoryview(cols).cast("B"))
    if precision != "default":
        h.update(f"precision={precision}".encode())
    return h.hexdigest()


@dataclasses.dataclass
class StoreStats:
    """Running counters; ``hits``/``disk_hits`` vs ``misses`` is the
    serve-traffic amortization."""
    hits: int = 0           # in-memory LRU hits
    disk_hits: int = 0      # restored from the disk tier
    misses: int = 0         # full ``prepare`` re-runs
    evictions: int = 0      # LRU drops (memory and block tiers)
    disk_writes: int = 0    # entries persisted
    resume_misses: int = 0  # misses during a warm-start resume
    block_hits: int = 0     # per-block reuses (``blockwise_factors``)
    block_misses: int = 0   # per-block refactorizations

    @property
    def total_hits(self) -> int:
        return self.hits + self.disk_hits


class BlockReuse(NamedTuple):
    """What a ``blockwise_factors`` assembly reused vs refactorized."""
    reused: int
    prepared: int


def block_fingerprint(solver_name: str, A_block, params: Dict[str, Any],
                      precision: str = "default") -> str:
    """Content hash of ONE row block's factorization inputs: solver, the
    block's (p, n) slice shape, dtype, params, bytes and a non-default
    precision — the reference's block digest."""
    A_block = (_host(A_block) if isinstance(A_block, torch.Tensor)
               else np.ascontiguousarray(A_block))
    h = hashlib.sha256()
    h.update(f"block-solver={solver_name}".encode())
    h.update(f"slice={tuple(A_block.shape)}".encode())
    h.update(f"dtype={A_block.dtype}".encode())
    _param_tokens(h, params)
    h.update(memoryview(A_block).cast("B"))
    if precision != "default":
        h.update(f"precision={precision}".encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Factor structures: (de)serialization and tree maps.  Factors are
# NamedTuples / tuples / dicts of tensors with optional None fields; the
# structure is recorded in the manifest so a COLD process restores an
# entry without a ``prepare`` template.
# ---------------------------------------------------------------------------


def _encode(node: Any, leaves: list) -> Any:
    if node is None:
        return {"kind": "none"}
    if hasattr(node, "_fields"):                       # NamedTuple
        cls = type(node)
        return {"kind": "namedtuple",
                "cls": f"{cls.__module__}:{cls.__qualname__}",
                "fields": [[f, _encode(getattr(node, f), leaves)]
                           for f in node._fields]}
    if isinstance(node, dict):
        return {"kind": "dict",
                "items": [[k, _encode(v, leaves)]
                          for k, v in sorted(node.items())]}
    if isinstance(node, (list, tuple)):
        return {"kind": "list" if isinstance(node, list) else "tuple",
                "items": [_encode(v, leaves) for v in node]}
    leaves.append(node)
    return {"kind": "leaf", "index": len(leaves) - 1}


def _check_classes(spec: Any, path: str) -> None:
    """Refuse an entry whose structure names another package's classes
    (a factor directory the reference wrote)."""
    if spec.get("kind") == "namedtuple":
        if not spec["cls"].startswith("repro_torch."):
            raise ValueError(
                f"factor-store entry at {path} holds {spec['cls']!r}, not "
                f"a class of repro_torch: the port does not read factor "
                f"entries another package wrote")
        for _, s in spec["fields"]:
            _check_classes(s, path)
    for s in spec.get("items", []):
        _check_classes(s[1] if spec["kind"] == "dict" else s, path)


def _decode(spec: Any, leaves: list) -> Any:
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "leaf":
        return leaves[spec["index"]]
    if kind == "namedtuple":
        mod, qual = spec["cls"].split(":")
        cls: Any = importlib.import_module(mod)
        for part in qual.split("."):
            cls = getattr(cls, part)
        return cls(**{f: _decode(s, leaves) for f, s in spec["fields"]})
    if kind == "dict":
        return {k: _decode(s, leaves) for k, s in spec["items"]}
    if kind in ("list", "tuple"):
        items = [_decode(s, leaves) for s in spec["items"]]
        return items if kind == "list" else tuple(items)
    raise ValueError(f"unknown factor-structure node kind {kind!r}")


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of same-structured factor trees."""
    first = trees[0]
    if first is None:
        return None
    if hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *kids)
                             for kids in zip(*trees)))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *kids) for kids in zip(*trees))
    return fn(*trees)


class FactorStore:
    """Content-addressed cache of b-independent solver factorizations.

    ``factors(solver, sys, **params)`` is the one entry point; drivers
    pass the store down on ``ExecutionPlan(store=...)``.
    """

    def __init__(self, capacity: int = 8,
                 directory: Optional[str] = None,
                 block_capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if block_capacity < 1:
            raise ValueError(
                f"block_capacity must be >= 1, got {block_capacity}")
        self.capacity = capacity
        self.block_capacity = block_capacity
        self.directory = directory
        self.stats = StoreStats()
        self._mem: "OrderedDict[str, Any]" = OrderedDict()
        self._block_mem: "OrderedDict[str, Any]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def clear(self) -> None:
        """Drop the memory tier (the disk tier, if any, is untouched)."""
        self._mem.clear()

    def holds(self, key: str, factors: Any) -> bool:
        """Whether the memory tier's entry under ``key`` is ``factors``
        itself (not evicted, not replaced).  Counts nothing."""
        return self._mem.get(key) is factors

    # ----- keys ------------------------------------------------------------
    @staticmethod
    def _as_solver(solver):
        if isinstance(solver, str):
            from .registry import get
            return get(solver)
        return solver

    def key(self, solver, sys: BlockSystem, *, precision: str = "default",
            **params) -> str:
        """The content-addressed key a ``factors`` call would use."""
        solver = self._as_solver(solver)
        prm = solver.resolve_params(sys, **params)
        return fingerprint(solver.name, sys, prm, precision)

    # ----- the one way to obtain factors ------------------------------------
    def factors(self, solver, sys: BlockSystem, *, use_kernel: bool = False,
                resume: bool = False, key: Optional[str] = None,
                precision: str = "default", **params):
        """Cached ``solver.prepare(sys.A_op, params)``.

        Lookup order: memory LRU -> disk tier -> full ``prepare`` (counted
        as a miss; persisted when a ``directory`` is configured).  A
        precomputed ``key`` (from ``self.key``) skips re-hashing A on hot
        serving paths; ``resume=True`` counts a miss as a resume miss.
        ``precision="mixed"`` entries cache the already-cast factors.
        """
        solver = self._as_solver(solver)
        prm = solver.resolve_params(sys, **params)
        if key is None:
            key = fingerprint(solver.name, sys, prm, precision)
        factors = self.lookup(solver, sys, key=key, use_kernel=use_kernel,
                              precision=precision, **prm)
        if factors is None:
            # the store IS the owner of the raw prepare call (reprolint
            # R003 allow-lists the reference's store.py for the same)
            fresh = solver.prepare(sys.A_op, prm)  # repro: allow[R003]
            factors = self.insert(solver, sys, fresh,
                                  resume=resume, key=key,
                                  use_kernel=use_kernel,
                                  precision=precision, **prm)
        return factors

    def _augment(self, solver, key: str, factors):
        """Kernel-path augmentation, ONCE per cache slot."""
        augmented = solver.kernel_factors(factors)
        if augmented is not factors and key in self._mem:
            self._mem[key] = augmented
        return augmented

    def lookup(self, solver, sys: BlockSystem, *,
               key: Optional[str] = None, use_kernel: bool = False,
               precision: str = "default", **params):
        """Memory/disk lookup that does NOT prepare on a miss (returns
        None instead); ``use_kernel=True`` augments a hit once per slot."""
        solver = self._as_solver(solver)
        if key is None:
            prm = solver.resolve_params(sys, **params)
            key = fingerprint(solver.name, sys, prm, precision)
        factors = self._mem.get(key)
        if factors is not None:
            self._mem.move_to_end(key)
            self.stats.hits += 1
            return self._augment(solver, key, factors) if use_kernel \
                else factors
        factors = self._disk_load(key, solver, sys)
        if factors is not None:
            self.stats.disk_hits += 1
            self._insert(key, factors)
            return self._augment(solver, key, factors) if use_kernel \
                else factors
        return None

    def insert(self, solver, sys: BlockSystem, factors, *,
               resume: bool = False, key: Optional[str] = None,
               use_kernel: bool = False, precision: str = "default",
               **params):
        """Record a caller-prepared factorization: counts the miss, adds
        the pinv augmentation (``use_kernel``), casts a non-default
        ``precision`` LAST, persists to the disk tier and caches it."""
        solver = self._as_solver(solver)
        prm = solver.resolve_params(sys, **params)
        if key is None:
            key = fingerprint(solver.name, sys, prm, precision)
        if use_kernel:
            factors = solver.kernel_factors(factors)
        if precision != "default":
            factors = solver.cast_factors(factors, precision)
        self.stats.misses += 1
        if resume:
            self.stats.resume_misses += 1
            log.warning(
                "factor-store MISS during warm-start resume: re-running "
                "the full b-independent prepare for solver %r (configure "
                "a disk tier to amortize resumes across processes)",
                solver.name)
        self._disk_store(key, solver, sys, prm, factors)
        self._insert(key, factors)
        return factors

    def _insert(self, key: str, factors: Any) -> None:
        self._mem[key] = factors
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats.evictions += 1

    # ----- block tier (per-block reuse across repartitions) -----------------
    # Valid only for solvers whose ``prepare`` is per-block independent
    # and whose factor leaves all carry a leading worker axis
    # (``supports_block_store``: APC, consensus and Cimmino).

    def blockwise_factors(self, solver, sys: BlockSystem, *,
                          use_kernel: bool = False,
                          precision: str = "default", **params):
        """``(factors, BlockReuse)`` for ``sys`` with per-block caching:
        one ``block_hit`` per reused block, one ``block_miss`` per
        refactorized one (the missing blocks in ONE stacked ``prepare``).
        The assembled entry also seeds the whole-system tiers."""
        solver = self._as_solver(solver)
        if not getattr(solver, "supports_block_store", False):
            raise ValueError(
                f"solver {solver.name!r} does not declare a per-block-"
                f"independent prepare (supports_block_store=False); "
                f"blockwise reuse would assemble wrong factors")
        if sys.is_sparse:
            raise ValueError(
                "blockwise factor reuse is dense-only: sparse operands "
                "carry a shared column support that a per-block cache "
                "cannot slice; densify() or use the whole-system tiers")
        prm = solver.resolve_params(sys, **params)
        A = sys.A_blocks
        keys = [block_fingerprint(solver.name, A[i], prm, precision)
                for i in range(sys.m)]
        blocks: Dict[int, Any] = {}
        for i, bk in enumerate(keys):
            blk = self._block_lookup(bk, sys.device)
            if blk is not None:
                blocks[i] = blk
        missing = [i for i in range(sys.m) if i not in blocks]
        self.stats.block_hits += sys.m - len(missing)
        self.stats.block_misses += len(missing)
        if missing:
            missing_blocks = A[torch.as_tensor(missing, device=A.device)]
            sub = solver.prepare(missing_blocks, prm)  # repro: allow[R003]
            for j, i in enumerate(missing):
                blk = _tree_map(lambda leaf: leaf[j].clone(), sub)
                self._block_insert(keys[i], solver, prm, blk)
                blocks[i] = blk
        factors = _tree_map(lambda *leaves: torch.stack(leaves, dim=0),
                            *[blocks[i] for i in range(sys.m)])
        reuse = BlockReuse(reused=sys.m - len(missing),
                           prepared=len(missing))
        # seed the whole-system tiers (not through ``insert``: an assembly
        # is neither a system-level hit nor a miss)
        sys_key = fingerprint(solver.name, sys, prm, precision)
        if use_kernel:
            factors = (self._augment(solver, sys_key, factors)
                       if sys_key in self._mem
                       else solver.kernel_factors(factors))
        if precision != "default":
            factors = solver.cast_factors(factors, precision)
        if sys_key not in self._mem:
            self._disk_store(sys_key, solver, sys, prm, factors)
            self._insert(sys_key, factors)
        return factors, reuse

    def _block_lookup(self, key: str, device):
        blk = self._block_mem.get(key)
        if blk is not None:
            self._block_mem.move_to_end(key)
            return blk
        blk = self._block_disk_load(key, device)
        if blk is not None:
            self._block_mem[key] = blk
            self._trim_blocks()
        return blk

    def _block_insert(self, key: str, solver, prm: Dict[str, Any],
                      blk: Any) -> None:
        self._block_mem[key] = blk
        self._block_mem.move_to_end(key)
        self._trim_blocks()
        self._block_disk_store(key, solver, prm, blk)

    def _trim_blocks(self) -> None:
        while len(self._block_mem) > self.block_capacity:
            self._block_mem.popitem(last=False)
            self.stats.evictions += 1

    def _block_dir(self, key: str) -> str:
        return os.path.join(self.directory, "blocks", key)

    def _block_disk_store(self, key: str, solver, prm: Dict[str, Any],
                          blk: Any) -> None:
        if self.directory is None:
            return
        root = os.path.join(self.directory, "blocks")
        os.makedirs(root, exist_ok=True)
        self._write(os.path.join(root, f"tmp.{key}"), self._block_dir(key),
                    blk, {"key": key, "solver": solver.name,
                          "params": {k: float(v) for k, v in prm.items()}})

    def _block_disk_load(self, key: str, device) -> Any:
        if self.directory is None:
            return None
        path = self._block_dir(key)
        if not os.path.exists(os.path.join(path, COMMIT)):
            return None
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return self._read(path, manifest, device,
                          "factor-store block entry corrupt")

    # ----- disk tier --------------------------------------------------------
    def _entry_dir(self, key: str) -> str:
        return os.path.join(self.directory, key)

    def _write(self, tmp: str, final: str, factors: Any,
               manifest: dict) -> None:
        """One committed entry: the checkpoint layout of ``ckpt``."""
        ckpt.fresh_dir(tmp)
        leaves: list = []
        manifest["structure"] = _encode(factors, leaves)
        manifest["leaves"] = ckpt.write_leaves(tmp, leaves)
        ckpt.seal(tmp, final, manifest)
        self.stats.disk_writes += 1

    @staticmethod
    def _read(path: str, manifest: dict, device, corrupt: str) -> Any:
        _check_classes(manifest["structure"], path)
        leaves = []
        for i, ref in enumerate(manifest["leaves"]):
            arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
            if list(arr.shape) != list(ref["shape"]) \
                    or str(arr.dtype) != ckpt.file_dtype(ref["dtype"]):
                raise ValueError(
                    f"{corrupt} at {path}: leaf {i} is "
                    f"{arr.shape}/{arr.dtype}, manifest says "
                    f"{ref['shape']}/{ref['dtype']}")
            leaves.append(ckpt.from_numpy(arr, ref["dtype"], device))
        return _decode(manifest["structure"], leaves)

    def _disk_store(self, key: str, solver, sys: BlockSystem,
                    prm: Dict[str, Any], factors: Any) -> None:
        if self.directory is None:
            return
        os.makedirs(self.directory, exist_ok=True)
        self._write(os.path.join(self.directory, f"tmp.{key}"),
                    self._entry_dir(key), factors, {
                        "key": key,
                        "solver": solver.name,
                        "partition": [sys.m, sys.p, sys.n],
                        "system_structure": sys.structure,
                        "dtype": ckpt.dtype_name(sys.A_blocks),
                        "params": {k: float(v) for k, v in prm.items()}})

    def _disk_load(self, key: str, solver, sys: BlockSystem) -> Any:
        """Restore a committed entry onto the system's device, failing
        LOUDLY on manifest drift."""
        if self.directory is None:
            return None
        path = self._entry_dir(key)
        if not os.path.exists(os.path.join(path, COMMIT)):
            return None
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        want_part = [sys.m, sys.p, sys.n]
        want_dtype = ckpt.dtype_name(sys.A_blocks)
        if manifest.get("solver") != solver.name:
            raise ValueError(
                f"factor-store manifest drift at {path}: entry was written "
                f"by solver {manifest.get('solver')!r}, requested "
                f"{solver.name!r}")
        if manifest.get("system_structure", "dense") != sys.structure:
            raise ValueError(
                f"factor-store manifest drift at {path}: entry holds "
                f"{manifest.get('system_structure', 'dense')!r} factors, "
                f"requested {sys.structure!r} — the fingerprint should "
                f"have separated these; entry may be corrupt")
        if list(manifest.get("partition", [])) != want_part:
            raise ValueError(
                f"factor-store manifest drift at {path}: partition "
                f"{manifest.get('partition')} != running {want_part} — was "
                f"the system re-partitioned since the entry was written?")
        if manifest.get("dtype") != want_dtype:
            raise ValueError(
                f"factor-store manifest drift at {path}: dtype "
                f"{manifest.get('dtype')} != running {want_dtype} — was the "
                f"float width changed since the entry was written?")
        return self._read(path, manifest, sys.device,
                          "factor-store entry corrupt")
