"""Dispatch-level cost counter — the port's counterpart of the JAX
package's ``repro/core/hlo_cost.py`` (`HloCost`, `analyze`).

The reference walks compiled HLO text and recovers loop trip counts,
because XLA's own cost analysis counts a while body once. PyTorch runs
eagerly: every iteration of every loop dispatches its ops, so the port
counts what the step dispatches, op by op, under a `TorchDispatchMode`
(`CostCounter`), and there are no trip counts to recover. The step runs
as it is — on ``meta`` tensors (shapes only: nothing is allocated and
nothing computed, which is how `launch.dryrun` counts a full-width step
on any machine), on the CPU or on the card — and the count is the same
on all three.

Conventions (those of the reference where an op has an HLO
counterpart):
  - products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, SDPA): 2 *
    output elements * contracted size, in rate
    class "bf16" (tensor cores) for bf16 / fp16 operands, else "fp32"
    (`roofline.FLOP_CLASSES`); a fused bias add counts its elements;
  - pointwise arithmetic: output elements ("fp32"); comparisons,
    copies and conversions: 0; transcendentals counted apart as well;
  - reductions: input elements; softmax and log-softmax as the
    reductions and pointwise ops the reference's jnp lowers them to;
  - ``bytes_accessed``: operands + outputs of every op that is not a
    view or an allocation: what eager PyTorch moves;
  - ``bytes_accessed_fused``: only the reference's ``FUSED_BYTES_OPS``
    classes (products, copies, gathers, scatters, concatenations, pads,
    sorts, reductions, cumulative sums, collectives) with its slice and
    scatter rules (`_traffic_bytes`): the traffic left once elementwise
    chains are fused, the memory term of the roofline;
  - the six hand-written kernels: each call is one entry of its spec's
    ``work`` (`repro_torch.kernels.count`), whatever route or plain
    version runs it; the body's own ops are hidden. Its bytes join both
    byte counts, its flops their classes;
  - collectives (``_c10d_functional.*``): operand bytes, under the
    reference's names;
  - live bytes: storages created by the counted ops and kernels, added
    when created and taken off when freed; the peak is the step's temp
    high-water mark beside the arguments it was given.

Positions: a plan over a mesh (`train.sharding.TrainPlan`) marks the
tensors each mesh position holds (`kernels.count.tag`); an op counts at
the position of the marked tensors it reads, and so do its outputs. An
op that reads none counts at the next op that does (the allocations and
index ops inside one shard's work), or at the position a `count.at`
context names; an op that reads two positions' tensors (the engine's
gradient sums across a seam) counts in the totals and under "mixed".
A seam hides its own arithmetic (`count.hidden`) and records the
collective it stands for (`count.collective`): kind and operand bytes
per device, as the reference's `analyze` counts them. `position_summary`
gives one position's flops, bytes, kernel entries, collectives and
peak live bytes (storages its ops created).

`summary()` has the reference's keys (``flops``, ``bytes_accessed``,
``bytes_accessed_fused``, ``transcendentals``, ``collectives``,
``warnings``, always empty) plus ``flops_by_class``, ``kernels`` (per
kernel: entries, bytes, flops by class), ``kernel_routes`` (entries per
route; "plain" on the CPU), ``ops`` and ``peak_live_bytes``. With
``inspect=True`` the counter also keeps bytes per (op, shape, source) for
`repro_torch.core.hlo_inspect` (collectives always); the source is the
innermost ``torch.profiler.record_function`` range open at the op, then
the innermost function of the port on the Python stack.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.roofline import COLLECTIVES, total_flops
from repro_torch.kernels import count as kernel_count

MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm"}
SDPA = {"_scaled_dot_product_flash_attention",
        "_scaled_dot_product_efficient_attention",
        "_scaled_dot_product_cudnn_attention",
        "_scaled_dot_product_attention_math"}
ZERO_FLOP = {"copy", "_to_copy", "clone", "fill", "zero", "eq", "ne", "lt",
             "le", "gt", "ge", "isnan", "isinf", "isfinite"}
TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
                  "tanh", "rsqrt", "sqrt", "pow", "sigmoid", "erf", "erfc",
                  "erfinv", "cos", "sin", "tan", "atan2", "softplus", "silu",
                  "gelu", "logit"}
SOFTMAX = {"_softmax": (5, 1), "_log_softmax": (5, 1),
           "_softmax_backward_data": (4, 0),
           "_log_softmax_backward_data": (4, 1)}   # (flops, trans) per elem
NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh",
            "_local_scalar_dense", "resize", "set", "record_stream",
            "wait_tensor"}
# ops that pass a scratch buffer from forward to backward whose size the
# backend chooses (the CPU's is full, the card's empty): (inputs, outputs)
# counted, the buffer left out so the count is the same on every device
BACKEND_SCRATCH = {"log_sigmoid_forward": (1, 1),
                   "log_sigmoid_backward": (2, 1)}
# op -> HLO class of the reference's FUSED_BYTES_OPS
FUSED_CLASS = {
    **dict.fromkeys(MATMUL | SDPA, "dot"),
    "clone": "copy", "copy": "copy",
    **dict.fromkeys(("index", "index_select", "gather", "embedding",
                     "take", "take_along_dim", "narrow_copy",
                     "slice_copy"), "gather"),
    **dict.fromkeys(("scatter", "scatter_add", "scatter_reduce",
                     "index_put", "index_add", "index_copy",
                     "masked_scatter", "embedding_dense_backward"),
                    "scatter"),
    **dict.fromkeys(("slice_scatter", "select_scatter",
                     "diagonal_scatter"), "dynamic-update-slice"),
    "cat": "concatenate", "constant_pad_nd": "pad", "pad": "pad",
    **dict.fromkeys(("sort", "topk", "argsort", "msort", "kthvalue"),
                    "sort"),
    **dict.fromkeys(("cumsum", "cumprod", "logcumsumexp"), "cumsum"),
    **dict.fromkeys(SOFTMAX, "reduce"),
}
COLLECTIVE_OPS = {"all_reduce": "all-reduce",
                  "all_gather_into_tensor": "all-gather",
                  "reduce_scatter_tensor": "reduce-scatter",
                  "all_to_all_single": "all-to-all",
                  "broadcast": "collective-broadcast"}
_SKIP_FRAMES = ("core/hlo_cost.py", "kernels/count.py")
MIXED = "mixed"


class _Bucket:
    """One position's share of a count."""

    def __init__(self):
        self.flops_by_class: dict = defaultdict(int)
        self.bytes = 0
        self.bytes_fused = 0
        self.transcendentals = 0
        self.entries: list = []
        self.collectives = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        self.ops = 0
        self.live = 0
        self.peak = 0
        # the position's collective rows and, with inspect=True, op rows
        self.rows: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.coll_rows: dict = defaultdict(lambda: {"count": 0, "bytes": 0})

    def add(self, flops: dict, nbytes: int, fused: int, trans: int,
            ops: int = 1):
        for c, f in flops.items():
            self.flops_by_class[c] += f
        self.bytes += nbytes
        self.bytes_fused += fused
        self.transcendentals += trans
        self.ops += ops

    def merge(self, other: "_Bucket"):
        self.add(other.flops_by_class, other.bytes, other.bytes_fused,
                 other.transcendentals, other.ops)
        self.entries += other.entries
        for k, v in other.collectives.items():
            self.collectives[k]["count"] += v["count"]
            self.collectives[k]["bytes"] += v["bytes"]
        for mine, theirs in ((self.rows, other.rows),
                             (self.coll_rows, other.coll_rows)):
            for key, row in theirs.items():
                mine[key]["count"] += row["count"]
                mine[key]["bytes"] += row["bytes"]


def _base(op) -> str:
    """The op's name without its in-place underscore: ``add_`` -> add."""
    name = op.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _flop_class(t) -> str:
    return "bf16" if t.dtype in (torch.bfloat16, torch.float16) else "fp32"


class CostCounter(TorchDispatchMode):
    """Counts what runs inside ``with CostCounter() as c:``; read
    ``c.summary()``. See the module docstring for what is counted."""

    def __init__(self, *, inspect: bool = False):
        super().__init__()
        self.inspect = inspect
        self.flops_by_class: dict = defaultdict(int)
        self.bytes = 0
        self.bytes_fused = 0
        self.transcendentals = 0
        self.collectives = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        self.entries: list = []          # one dict per kernel call
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.rows: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.coll_rows: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
        self._storages: dict = {}
        self._ranges: list = []
        self._hidden = 0
        # positions (see the module docstring)
        self._tags = WeakIdKeyDictionary()
        self.by_position: dict = defaultdict(_Bucket)
        self._pending = _Bucket()
        self._pending_live: list = []
        self._at: list = []
        self._last = None

    # -- mode plumbing -------------------------------------------------------
    def __enter__(self):
        kernel_count._ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_count._ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":
            return self._range(func, args, kwargs)
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _range(self, func, args, kwargs):
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name.startswith("_record_function_enter"):
            self._ranges.append(args[0])
        elif name.startswith("_record_function_exit") and self._ranges:
            self._ranges.pop()
        return out

    # -- positions ------------------------------------------------------------
    def tag(self, t, pos):
        """Mark `t` (a tensor, or a tree of them) as position `pos`'s."""
        for x in _tensors(t):
            self._tags[x] = pos

    def hide(self):
        counter = self

        class _Hide:
            def __enter__(self):
                counter._hidden += 1

            def __exit__(self, *exc):
                counter._hidden -= 1
                return False

        return _Hide()

    def at(self, pos):
        counter = self

        class _At:
            def __enter__(self):
                counter._at.append(pos)

            def __exit__(self, *exc):
                counter._at.pop()
                return False

        return _At()

    def collective(self, kind: str, nbytes: int, pos=None, shape=None):
        """One collective of `kind` with `nbytes` operand bytes, at `pos`
        (None: the totals only); its row (`coll_rows`) under `shape`, the
        operand's (None: not known)."""
        for b in ([self.collectives] + ([self.by_position[pos].collectives]
                                        if pos is not None else [])):
            b[kind]["count"] += 1
            b[kind]["bytes"] += int(nbytes)
        key = (kind, str(tuple(shape))[:60] if shape is not None else "()",
               self._source())
        for rows in [self.coll_rows] + ([self.by_position[pos].coll_rows]
                                        if pos is not None else []):
            rows[key]["count"] += 1
            rows[key]["bytes"] += int(nbytes)

    def _position(self, ins):
        """The position of an op reading `ins`: their one marked position,
        `MIXED`, or None (none marked: the innermost `at` position, if
        any, which its outputs do not take)."""
        if not self._tags:
            return None
        found = None
        for t in ins:
            p = self._tags.get(t)
            if p is None or p == found:
                continue
            if found is not None:
                return MIXED
            found = p
        return found

    def _attribute(self, pos, flops, nbytes, fused, trans, new_live=()):
        """Add one op's share to `pos`'s bucket (to the pending bucket when
        None: the next marked op takes it)."""
        if pos is None:
            self._pending.add(flops, nbytes, fused, trans)
            self._pending_live += list(new_live)
            return
        b = self.by_position[pos]
        if self._pending.ops or self._pending.rows:
            b.merge(self._pending)
            self._pending = _Bucket()
        b.add(flops, nbytes, fused, trans)
        if pos != MIXED:
            self._last = pos
        for holder in self._pending_live + list(new_live):
            if len(holder) > 1:
                holder[0] = pos
                b.live += holder[1]
                b.peak = max(b.peak, b.live)
        self._pending_live = []

    # -- live bytes -----------------------------------------------------------
    def _track(self, t, nbytes=None, holder=None):
        """Count a new storage as live until it is freed; `holder` (a
        one-entry list) names the position it counts at, once known."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(key=key, n=n, holder=holder):
            self.live -= n
            self._storages.pop(key, None)
            if holder is not None and holder[0] is not None:
                self.by_position[holder[0]].live -= n

        self._storages[key] = weakref.finalize(st, freed)
        if holder is not None:
            holder.append(n)

    # -- kernels --------------------------------------------------------------
    def kernel(self, name, route, work, run, inputs=()):
        """One kernel call (`repro_torch.kernels.count.call`): `work()`
        and `run()` with the counter's view of their ops hidden, one
        entry (at the position of `inputs`), the outputs tracked as new
        storages."""
        self._hidden += 1
        try:
            w = work()
            # the kernels return contiguous outputs; the plain versions
            # may return views of another layout, which would change the
            # ops (copies) that follow them
            out = tree_map(lambda t: t.contiguous()
                           if isinstance(t, torch.Tensor) else t, run())
        finally:
            self._hidden -= 1
        entry = {"kernel": name, "route": route, "bytes": w["bytes"],
                 "flops": dict(w["flops"]),
                 **{k: v for k, v in w.items() if k not in ("bytes",
                                                            "flops")}}
        self.entries.append(entry)
        for c, f in entry["flops"].items():
            self.flops_by_class[c] += f
        self.bytes += entry["bytes"]
        self.bytes_fused += entry["bytes"]
        pos = self._position(_tensors(inputs)) if self._tags else None
        if pos is None and self._tags:
            pos = self._at[-1] if self._at else self._last
        holders = []
        for t in _tensors(out):
            holders.append([None])
            self._track(t, _nbytes(t), holders[-1])
        if pos is not None:
            self._attribute(pos, entry["flops"], entry["bytes"],
                            entry["bytes"], 0, holders)
            self.by_position[pos].ops -= 1
            self.by_position[pos].entries.append(entry)
            self.tag(out, pos)
        if self.inspect:
            self._row(f"kernel:{name}", _tensors(out), entry["bytes"], pos)
        return out

    # -- ops ------------------------------------------------------------------
    def _count(self, func, args, kwargs, out):
        self.ops += 1
        base = _base(func)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        pos = self._position(ins)
        if pos is not None and pos != MIXED:
            self.tag(outs, pos)
        elif pos is None and self._at and self._tags:
            pos = self._at[-1]
        if func.is_view or base in NO_BYTES:
            if pos is not None:
                self._attribute(pos, {}, 0, 0, 0)
            return
        if base in BACKEND_SCRATCH:
            n_in, n_out = BACKEND_SCRATCH[base]
            ins, outs = ins[:n_in], outs[:n_out]
        before = (dict(self.flops_by_class), self.bytes, self.bytes_fused,
                  self.transcendentals) if self._tags else None
        holders = []
        returns = func._schema.returns
        for i, t in enumerate(outs):
            # an output that aliases an input (in-place ops, returned
            # views) is no new storage
            if i >= len(returns) or returns[i].alias_info is None:
                holders.append([None])
                self._track(t, holder=holders[-1])
        if not outs and base.startswith("_foreach_") and args:
            outs = _tensors(args[0])            # in-place foreach
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        self.bytes += in_b + out_b
        self._flops(func, base, ins, outs)
        self._fused(func, base, ins, outs, in_b, out_b)
        if func.namespace == "_c10d_functional" and base in COLLECTIVE_OPS:
            self.collective(COLLECTIVE_OPS[base], in_b,
                            pos if self._tags else None,
                            ins[0].shape if ins else None)
            self.bytes_fused += in_b + out_b
        if before is not None:
            flops = {c: f - before[0].get(c, 0)
                     for c, f in self.flops_by_class.items()
                     if f != before[0].get(c, 0)}
            self._attribute(pos, flops, self.bytes - before[1],
                            self.bytes_fused - before[2],
                            self.transcendentals - before[3], holders)
        if self.inspect:
            self._row(base, outs or ins, in_b + out_b, pos)

    def _flops(self, func, base, ins, outs):
        out_n = sum(t.numel() for t in outs)
        if base in MATMUL:
            a, b = ins[-2], ins[-1]
            flops = 2 * out_n * a.shape[-1]
            self.flops_by_class[_flop_class(a)] += flops
            if base in ("addmm", "baddbmm", "addbmm"):
                self.flops_by_class["fp32"] += out_n
            return
        if base in SDPA:
            q, k = ins[0], ins[1]
            b, h, sq, d = q.shape
            self.flops_by_class[_flop_class(q)] += \
                4 * b * h * sq * k.shape[-2] * d
            return
        if base in SOFTMAX:
            n = ins[0].numel()
            f, tr = SOFTMAX[base]
            self.flops_by_class["fp32"] += f * n
            self.transcendentals += tr * n
            return
        if base.startswith("_foreach_"):
            op = base.removeprefix("_foreach_")
            if op not in ZERO_FLOP:
                self.flops_by_class["fp32"] += out_n
                if op in TRANSCENDENTAL:
                    self.transcendentals += out_n
            return
        tags = func.tags
        if torch.Tag.pointwise in tags:
            if base not in ZERO_FLOP:
                self.flops_by_class["fp32"] += out_n
                if base in TRANSCENDENTAL:
                    self.transcendentals += out_n
        elif torch.Tag.reduction in tags or base in ("cumsum", "cumprod"):
            self.flops_by_class["fp32"] += max(ins[0].numel() if ins else 0,
                                               out_n)

    def _fused(self, func, base, ins, outs, in_b, out_b):
        cls = FUSED_CLASS.get(base)
        if cls is None and torch.Tag.reduction in func.tags:
            cls = "reduce"
        if cls is None:
            return
        if cls == "gather":
            self.bytes_fused += 2 * out_b
        elif cls == "scatter":
            upd = ins[0] if base == "embedding_dense_backward" else ins[-1]
            self.bytes_fused += 2 * _nbytes(upd)
        elif cls == "dynamic-update-slice":
            self.bytes_fused += 2 * _nbytes(ins[1])
        elif cls == "copy" and base == "copy":
            dst, src = ins[0], ins[1]
            if dst.dtype == src.dtype:       # a dtype change is a convert
                self.bytes_fused += 2 * _nbytes(src)
        else:
            self.bytes_fused += in_b + out_b

    # -- inspection -----------------------------------------------------------
    def _source(self) -> str:
        if self._ranges:
            return self._ranges[-1]
        f = sys._getframe(2)
        while f is not None:
            name = f.f_code.co_filename.replace("\\", "/")
            if "repro_torch/" in name and not name.endswith(_SKIP_FRAMES):
                return (f"{name.rsplit('repro_torch/', 1)[1]}:"
                        f"{f.f_code.co_name}")
            f = f.f_back
        return "autograd"

    def _row(self, op, tensors, nbytes, pos=None):
        """One op's row in the totals and, in a plan's count, in `pos`'s
        bucket (the pending one when None: the next marked op takes it,
        as its bytes)."""
        shape = str(tuple(tensors[0].shape))[:48] if tensors else "()"
        key = (op, shape, self._source())
        tables = [self.rows]
        if self._tags:
            tables.append((self._pending if pos is None
                           else self.by_position[pos]).rows)
        for rows in tables:
            rows[key]["count"] += 1
            rows[key]["bytes"] += nbytes

    # -- results --------------------------------------------------------------
    def kernel_summary(self) -> tuple:
        """({kernel: {"entries", "bytes", "flops": {class: flops}}},
        {kernel: {route: entries}})."""
        return _kernel_summary(self.entries)

    def positions(self) -> list:
        """The positions counted, in order ("mixed" left out)."""
        return sorted(p for p in self.by_position if p != MIXED)

    def position_bucket(self, pos) -> _Bucket:
        """Position `pos`'s bucket, once ops still waiting for a marked op
        count at the last position seen."""
        if (self._pending.ops or self._pending.rows) and \
                self._last is not None:
            self._attribute(self._last, {}, 0, 0, 0)
            self.by_position[self._last].ops -= 1
        return self.by_position[pos]

    def position_summary(self, pos) -> dict:
        """Position `pos`'s share: ``flops``, ``flops_by_class``,
        ``bytes_accessed``, ``bytes_accessed_fused``, ``transcendentals``,
        ``kernels``, ``kernel_routes``, ``collectives`` (with totals) and
        ``peak_live_bytes``. Ops still waiting for a marked op count at
        the last position seen."""
        b = self.position_bucket(pos)
        kernels, routes = _kernel_summary(b.entries)
        by_class = {c: f for c, f in sorted(b.flops_by_class.items()) if f}
        colls = {k: dict(v) for k, v in b.collectives.items()}
        return {
            "flops": total_flops(by_class),
            "flops_by_class": by_class,
            "bytes_accessed": b.bytes,
            "bytes_accessed_fused": b.bytes_fused,
            "transcendentals": b.transcendentals,
            "collectives": {
                **colls,
                "total_bytes": sum(v["bytes"] for v in colls.values()),
                "total_count": sum(v["count"] for v in colls.values())},
            "kernels": kernels,
            "kernel_routes": routes,
            "peak_live_bytes": b.peak,
        }

    def summary(self) -> dict:
        colls = {k: dict(v) for k, v in self.collectives.items()}
        kernels, routes = self.kernel_summary()
        by_class = {c: f for c, f in sorted(self.flops_by_class.items())
                    if f}
        return {
            "flops": total_flops(by_class),
            "flops_by_class": by_class,
            "bytes_accessed": self.bytes,
            "bytes_accessed_fused": self.bytes_fused,
            "transcendentals": self.transcendentals,
            "collectives": {
                **colls,
                "total_bytes": sum(v["bytes"] for v in colls.values()),
                "total_count": sum(v["count"] for v in colls.values())},
            "warnings": [],        # the reference's; nothing is approximated
            "kernels": kernels,
            "kernel_routes": routes,
            "ops": self.ops,
            "peak_live_bytes": self.peak,
        }


def _kernel_summary(entries) -> tuple:
    kernels, routes = {}, {}
    for e in entries:
        k = kernels.setdefault(e["kernel"], {"entries": 0, "bytes": 0,
                                             "flops": {}})
        k["entries"] += 1
        k["bytes"] += e["bytes"]
        for c, f in e["flops"].items():
            k["flops"][c] = k["flops"].get(c, 0) + f
        r = routes.setdefault(e["kernel"], {})
        r[e["route"]] = r.get(e["route"], 0) + 1
    return kernels, routes


def count(fn, *args, inspect: bool = False, **kwargs):
    """``(fn(*args, **kwargs), the CostCounter that counted it)``."""
    with CostCounter(inspect=inspect) as c:
        out = fn(*args, **kwargs)
    return out, c


def analyze(fn, *args, **kwargs) -> dict:
    """The summary of one call of `fn` (the reference's `analyze` over a
    callable instead of HLO text)."""
    return count(fn, *args, **kwargs)[1].summary()
