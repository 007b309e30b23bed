"""Per-device FLOPs, HBM bytes, collective wire bytes and peak memory of an
eager step run under fake tensors: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference reads these from the optimized HLO text of a compiled XLA
program.  Eager PyTorch has no such program, so :class:`OpAnalysis` watches
the step run instead, as a ``TorchDispatchMode`` over ``FakeTensorMode``
(shapes, no allocation) on a fake process group of the production mesh's
size.  It counts on each op of one rank's *local* tensors:

  * **flops** — ``torch.utils.flop_counter``'s formulas (2·M·N·K a product,
    as the reference's 2·M·N·K a ``dot``), plus what each hand-written
    kernel's fake route reports (:func:`report_kernel`: the mathematical
    FLOPs behind its bound, not split-TF32 operations);
  * **hbm_bytes** — Σ (input + output bytes) over every aten op and kernel
    call; views move nothing, a gather reads its rows only (2 · result +
    index, the reference's ``gather``/``dynamic-slice`` rule) and a scatter
    writes its rows only (2 · update + index).  Every eager op round-trips
    memory, so each op boundary is the reference's top-level instruction
    boundary;
  * **collective wire bytes** — per collective, the reference's ring factor
    (:data:`_WIRE_FACTOR`) on the op's group size and result bytes, the
    functional collectives DTensor issues and the c10d ones
    (``torch.distributed.all_reduce``, ``batch_isend_irecv``) alike; a send
    is a ``collective-permute``;
  * **peak memory** — every storage an op creates is live until Python
    frees it (a weak reference on the fake storage), rounded up to the CUDA
    caching allocator's 512 bytes; the inputs registered with
    :meth:`OpAnalysis.track` are live from the start.  The peak is split by
    what holds the bytes: the registered categories (params, optimizer
    state, inputs), then what the step made in its forward ("activations")
    and in or after its backward ("temporaries").

DTensor runs each op twice in a sense: its sharding propagation runs the
op on fake tensors of the *global* shapes to learn the output's metadata,
then runs it on the local shards.  The propagation is no device work, so
the analysis skips every op inside it; only the local ops count
(``FlopCounterMode`` around a DTensor program counts the global op, the
unsharded FLOPs).

Usage::

    with FakeTensorMode(), OpAnalysis() as an:
        an.track("params", params)
        out = step(params, batch)
    an.stats(), an.memory()
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

#: bytes on the wire a chip per result byte, ring algorithms over a group of g
#: (a copy of ``repro.launch.hlo_analysis._WIRE_FACTOR``)
_WIRE_FACTOR = {
    "all-gather": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

TOP = 12  # the largest storages at the peak, and the op sites with most FLOPs, reported
#: the CUDA caching allocator's rounding of a block
ALLOC_ROUND = 512
#: cards a node holds: a group inside one node talks over NVLink, else over the network
NODE_CARDS = 8

_FUNCOL = {  # functional collective → (kind, position of group size or None)
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_out": ("all-gather", 1),
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
}
_C10D_OPS = {  # in-place c10d op → (kind, position of its ProcessGroup argument)
    "allreduce_": ("all-reduce", 1),
    "allgather_": ("all-gather", 2),
    "_allgather_base_": ("all-gather", 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 2),
    "reduce_scatter_": ("reduce-scatter", 2),
    "_reduce_scatter_base_": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 2),
    "alltoall_": ("all-to-all", 2),
    "alltoall_base_": ("all-to-all", 2),
    "send": ("collective-permute", 1),
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "_to_copy_meta", "set_", "resize_", "wait_tensor"}
_GATHERS = {"index", "index_select", "embedding", "gather", "take_along_dim"}
# scatter → position of the update operand
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "index_add": 3,
             "index_add_": 3, "scatter_add": 3, "scatter_add_": 3, "scatter": 3,
             "scatter_": 3, "index_copy": 3, "index_copy_": 3, "slice_scatter": 1,
             "select_scatter": 1}


@dataclasses.dataclass
class OpStats:
    """The reference's ``HLOStats`` fields, per device, plus the kernels' calls
    and the collectives' bytes by link."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, int]
    per_collective_bytes: Dict[str, float]
    # the reference subtracts the [.., Sq, Sk] attention buffers its CPU
    # lowering materialises; the port's attention never builds one (the
    # flash kernels stream it), so nothing is excluded and the two agree
    hbm_bytes_flash_adjusted: float = 0.0
    attn_matrix_bytes: float = 0.0
    collective_bytes_by_link: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0
    top_flops: Dict[str, float] = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _group_ranks(group) -> List[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    if isinstance(group, str):  # a functional collective's group name
        group = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):  # a c10d op's boxed ProcessGroup
        group = dist.ProcessGroup.unbox(group)
    return list(dist.get_process_group_ranks(group))


def _link(ranks) -> str:
    return "nvlink" if min(ranks) // NODE_CARDS == max(ranks) // NODE_CARDS else "network"


def _where() -> str:
    """``file:line function`` of the innermost frame of the port's model code
    (outside this module and the kernel wrappers' fake routes)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and not fn.endswith(("op_analysis.py", "_fake.py")):
            tail = fn[fn.rindex("repro_torch") + len("repro_torch") + 1:]
            return f"{tail}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Propagating:
    """DTensor's sharding propagator as the analysis sees it: each
    propagation is no device work, so its ops are skipped, and it runs with
    the fake mode unset (it reads small index tensors back to the host,
    which a fake tensor cannot give)."""

    _WRAPPED = ("propagate", "propagate_op_sharding", "propagate_op_sharding_non_cached")

    def __init__(self, inner, analysis: "OpAnalysis"):
        self._inner, self._analysis = inner, analysis

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self._WRAPPED:
            return attr

        return self._analysis._host_side(attr)


class OpAnalysis(TorchDispatchMode):
    """Counts one rank's work and memory over the ops it sees (module doc).
    Enter it inside ``FakeTensorMode``; register the step's inputs with
    :meth:`track` before running the step."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.kernel_flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_counts: Dict[str, int] = {}
        self.coll_bytes: Dict[str, float] = {}
        self.coll_link: Dict[str, float] = {}
        self.kernel_calls: Dict[str, int] = {}
        self.flops_where: Dict[str, float] = {}  # aten FLOPs by op and source line
        self._skip = 0  # > 0 inside DTensor's sharding propagation
        # memory: a record [bytes, category, label, t_alloc] a storage; the live
        # ones, and the freed ones that were live at the peak so far (no other
        # freed record can be live at a later peak)
        self._live: Dict[int, list] = {}  # id(record) → record
        self._freed_at_peak: List[list] = []
        self._refs: Dict[int, Any] = {}  # id(record) → weakref on its storage
        self._seen = WeakIdKeyDictionary()  # storage → its record
        self._t = 0
        self._cur = 0
        self._peak = 0
        self._peak_t = 0
        self._after_backward = False
        self._patched: List[tuple] = []

    # ------------------------------------------------------------------ #
    # set-up
    # ------------------------------------------------------------------ #
    def __enter__(self):
        from torch.distributed.tensor import DTensor

        dispatcher = DTensor._op_dispatcher
        self._patched.append((dispatcher, "sharding_propagator", dispatcher.sharding_propagator))
        dispatcher.sharding_propagator = _Propagating(dispatcher.sharding_propagator, self)
        # a strided shard's local rows come from an index tensor read back to the host
        from torch.distributed.tensor import placement_types

        strided = getattr(placement_types, "_StridedShard", None)
        orig = getattr(strided, "local_shard_size_and_offset", None)
        if orig is not None:
            self._patched.append((strided, "local_shard_size_and_offset", orig))
            strided.local_shard_size_and_offset = self._host_side(orig)
        return super().__enter__()

    def _host_side(self, fn):
        """``fn`` as index work on the host: its ops skipped, the fake mode unset."""
        def call(*args, **kwargs):
            from torch._subclasses.fake_tensor import unset_fake_temporarily

            self._skip += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                self._skip -= 1

        return call

    def __exit__(self, *exc):
        for obj, name, orig in reversed(self._patched):
            setattr(obj, name, orig)
        self._patched.clear()
        return super().__exit__(*exc)

    def track(self, category: str, tree) -> int:
        """Register the storages of ``tree``'s tensors (a DTensor's local
        shard) as live under ``category``; returns the bytes newly counted."""
        from torch.distributed.tensor import DTensor

        added = 0
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            added += self._alloc(t, category, "input")
        return added

    # ------------------------------------------------------------------ #
    # memory
    # ------------------------------------------------------------------ #
    def _alloc(self, t: torch.Tensor, category: str, label: str) -> int:
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = _rounded(st.nbytes())
        self._t += 1
        rec = [n, category, label, self._t]
        self._seen[st] = rec
        self._live[id(rec)] = rec
        self._refs[id(rec)] = weakref.ref(st, lambda _, r=rec: self._free(r))
        self._cur += n
        if self._cur > self._peak:
            self._peak, self._peak_t = self._cur, self._t
            self._freed_at_peak.clear()
        return n

    def _free(self, rec) -> None:
        self._t += 1
        self._cur -= rec[0]
        self._live.pop(id(rec), None)
        self._refs.pop(id(rec), None)
        if rec[3] <= self._peak_t:
            self._freed_at_peak.append(rec)

    def memory(self) -> Dict[str, Any]:
        """The peak and what was live at it: bytes by category, and the
        ``top`` largest storages the step made (creating op, shape, where)."""
        live = [r for r in self._live.values() if r[3] <= self._peak_t] + self._freed_at_peak
        by_cat: Dict[str, int] = {}
        for r in live:
            by_cat[r[1]] = by_cat.get(r[1], 0) + r[0]
        made = sorted((r for r in live if r[2] != "input"), key=lambda r: -r[0])[:TOP]
        return {
            "peak_bytes": self._peak,
            "peak_by_category": by_cat,
            "peak_top_storages": [{"bytes": r[0], "category": r[1], "made_by": r[2]}
                                  for r in made],
            "current_bytes": self._cur,
        }

    # ------------------------------------------------------------------ #
    # counting
    # ------------------------------------------------------------------ #
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One hand-written kernel's call (its fake route): FLOPs and the
        bytes its bound counts."""
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        if flops:
            key = f"{name} at {_where()}"
            self.flops_where[key] = self.flops_where.get(key, 0.0) + flops
        self.flops += flops
        self.kernel_flops += flops
        self.hbm_bytes += nbytes

    def _collective(self, kind: str, g: int, result_bytes: float, link: str) -> None:
        wire = result_bytes * _WIRE_FACTOR[kind](max(g, 1))
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + wire
        self.coll_link[link] = self.coll_link.get(link, 0.0) + wire

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in _FUNCOL:
            kind, gpos = _FUNCOL[name]
            ranks = _group_ranks(args[-1])
            g = args[gpos] if gpos is not None else len(ranks)
            self._collective(kind, g, sum(_nbytes(t) for t in _tensors(out)), _link(ranks))
            return
        if ns == "c10d":
            if name not in _C10D_OPS:
                return
            kind, at = _C10D_OPS[name]
            nb = sum(_nbytes(t) for t in _tensors(args[0]))  # the result (outputs first)
            if kind == "collective-permute":  # send(tensors, group, dst, tag): one pair
                import torch.distributed as dist

                self._collective(kind, 2, nb, _link([dist.get_rank(), args[2]]))
            else:
                ranks = _group_ranks(args[at])
                self._collective(kind, len(ranks), nb, _link(ranks))
            return
        if ns not in ("aten", "prims"):
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **(kwargs or {}), out_val=out)
            self.flops += f
            if f:
                key = f"{name} at {_where()}"
                self.flops_where[key] = self.flops_where.get(key, 0.0) + f
        if name in _NO_TRAFFIC or _is_view(func):
            return
        if name in _GATHERS:
            idx = [t for t in _tensors((args[1:], kwargs)) if not t.is_floating_point()]
            self.hbm_bytes += 2 * sum(_nbytes(t) for t in _tensors(out)) \
                + sum(_nbytes(t) for t in idx)
            return
        if name in _SCATTERS:
            upd = args[_SCATTERS[name]] if len(args) > _SCATTERS[name] else None
            ub = sum(_nbytes(t) for t in _tensors(upd))
            idx = [t for t in _tensors(args[1:_SCATTERS[name]]) if not t.is_floating_point()]
            self.hbm_bytes += 2 * ub + sum(_nbytes(t) for t in idx)
            return
        if name == "copy_":
            self.hbm_bytes += 2 * _nbytes(args[1]) if isinstance(args[1], torch.Tensor) else 0
            return
        self.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in _tensors(out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run its local ops, which come back here
        kwargs = kwargs or {}
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # eager returns its input; the fake kernel would make a new tensor
            out = args[0]
        else:
            out = func(*args, **kwargs)
        if self._skip:
            return out
        self._count(func, args, kwargs, out)
        if torch._C._current_graph_task_id() != -1:
            self._after_backward = True
            cat = "temporaries"
        else:
            cat = "temporaries" if self._after_backward else "activations"
        label = None
        for t in _tensors(out):
            if t.untyped_storage() in self._seen:
                continue
            if label is None:
                label = (f"{func._schema.name.split('::')[-1]} {tuple(t.shape)} {t.dtype} "
                         f"at {_where()}")
            self._alloc(t, cat, label)
        return out

    def stats(self) -> OpStats:
        cb = sum(self.coll_bytes.values())
        return OpStats(
            flops=self.flops,
            hbm_bytes=self.hbm_bytes,
            collective_bytes=cb,
            collective_counts=dict(self.coll_counts),
            per_collective_bytes=dict(self.coll_bytes),
            hbm_bytes_flash_adjusted=self.hbm_bytes,
            attn_matrix_bytes=0.0,
            collective_bytes_by_link=dict(self.coll_link),
            kernel_calls=dict(self.kernel_calls),
            kernel_flops=self.kernel_flops,
            top_flops=dict(sorted(self.flops_where.items(), key=lambda kv: -kv[1])[:TOP]),
        )


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def active() -> Optional[OpAnalysis]:
    """The innermost :class:`OpAnalysis` on the dispatch mode stack, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpAnalysis):
            return mode
    return None


def report_kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel wrapper's fake route reports its call here (nothing when no
    analysis is active)."""
    an = active()
    if an is not None:
        an.kernel(name, flops, nbytes)
