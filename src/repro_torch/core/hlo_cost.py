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

    # -- live bytes -----------------------------------------------------------
    def _track(self, t, nbytes=None):
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(key=key, n=n):
            self.live -= n
            self._storages.pop(key, None)

        self._storages[key] = weakref.finalize(st, freed)

    # -- kernels --------------------------------------------------------------
    def kernel(self, name, route, work, run):
        """One kernel call (`repro_torch.kernels.count.call`): `work()`
        and `run()` with the counter's view of their ops hidden, one
        entry, the outputs tracked as new storages."""
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
        for t in _tensors(out):
            self._track(t, _nbytes(t))
        if self.inspect:
            self._row(f"kernel:{name}", _tensors(out), entry["bytes"])
        return out

    # -- ops ------------------------------------------------------------------
    def _count(self, func, args, kwargs, out):
        self.ops += 1
        base = _base(func)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func.is_view or base in NO_BYTES:
            return
        if base in BACKEND_SCRATCH:
            n_in, n_out = BACKEND_SCRATCH[base]
            ins, outs = ins[:n_in], outs[:n_out]
        returns = func._schema.returns
        for i, t in enumerate(outs):
            # an output that aliases an input (in-place ops, returned
            # views) is no new storage
            if i >= len(returns) or returns[i].alias_info is None:
                self._track(t)
        if not outs and base.startswith("_foreach_") and args:
            outs = _tensors(args[0])            # in-place foreach
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        self.bytes += in_b + out_b
        self._flops(func, base, ins, outs)
        self._fused(func, base, ins, outs, in_b, out_b)
        if func.namespace == "_c10d_functional" and base in COLLECTIVE_OPS:
            name = COLLECTIVE_OPS[base]
            coll = self.collectives[name]
            coll["count"] += 1
            coll["bytes"] += in_b
            self.bytes_fused += in_b + out_b
            row = self.coll_rows[(name, str(tuple(ins[0].shape))[:60]
                                  if ins else "()", self._source())]
            row["count"] += 1
            row["bytes"] += in_b
        if self.inspect:
            self._row(base, outs or ins, in_b + out_b)

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

    def _row(self, op, tensors, nbytes):
        shape = str(tuple(tensors[0].shape))[:48] if tensors else "()"
        key = (op, shape, self._source())
        self.rows[key]["count"] += 1
        self.rows[key]["bytes"] += nbytes

    # -- results --------------------------------------------------------------
    def kernel_summary(self) -> tuple:
        """({kernel: {"entries", "bytes", "flops": {class: flops}}},
        {kernel: {route: entries}})."""
        kernels, routes = {}, {}
        for e in self.entries:
            k = kernels.setdefault(e["kernel"], {"entries": 0, "bytes": 0,
                                                 "flops": {}})
            k["entries"] += 1
            k["bytes"] += e["bytes"]
            for c, f in e["flops"].items():
                k["flops"][c] = k["flops"].get(c, 0) + f
            r = routes.setdefault(e["kernel"], {})
            r[e["route"]] = r.get(e["route"], 0) + 1
        return kernels, routes

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


def count(fn, *args, inspect: bool = False, **kwargs):
    """``(fn(*args, **kwargs), the CostCounter that counted it)``."""
    with CostCounter(inspect=inspect) as c:
        out = fn(*args, **kwargs)
    return out, c


def analyze(fn, *args, **kwargs) -> dict:
    """The summary of one call of `fn` (the reference's `analyze` over a
    callable instead of HLO text)."""
    return count(fn, *args, **kwargs)[1].summary()
