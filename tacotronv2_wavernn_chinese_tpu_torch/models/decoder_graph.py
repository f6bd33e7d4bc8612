"""The eager route's teacher-forced decode as CUDA graphs.

Under full teacher forcing every input of a decoder step is known before
the loop (the prenet runs batched before it, the projections after it),
so the loop over ``decoder_step`` runs one program T times.  On the card
``decode`` captures that step once per key as a CUDA graph and replays it
T times: a step costs one graph launch in place of some fifty eager
launches.  The key is what the code observes: the device, the batch, the
encoder length, the weights' dtype and widths, the model configuration
(attention mode and flags), train or eval, whether a gradient is wanted,
which masks are given and the f32 precision flags.  Never T.

The backward is one more graph per key, replayed from the last step to the
first.  Replay t recomputes step t from the carry the forward saved at t,
with autograd on, and takes the step's vector-Jacobian product
(``torch.autograd.grad``): the carry's cotangent at t, which the next
replay reads; the step input's gradient, into its slot; and the gradients
of the decoder's weights, the keys, the memory and the hoisted location
filter, added into accumulators in the order eager autograd sums them
(the last step's first).  The step's activations are recomputed, not
saved, so memory grows with T by the slots below only.

Slots.  A graph reads and writes fixed addresses.  Every per-step tensor
(the prenet output, the zoneout and GMM keep-masks, the outputs, the carry
each step starts from, the cotangents) lives in a slot of a ``[T_cap, ...]``
buffer of one arena that every key shares, since a process decodes one
batch at a time; a step counter on the device picks the slot inside the
graph (``index_select``, ``index_copy_``), so a replay takes no host copy.
The caller's tensors and weights are copied into the slots and static
buffers once a decode, the outputs copied out once.  A decode longer than
``T_cap`` grows the arena (to at least twice its length), which drops every
key's graphs: each captures again at its next use.

One forward's saves at a time.  A forward with gradients holds the arena
until its backward has run (or its autograd graph is freed).  A decode in
between raises ``ArenaBusy`` instead of overwriting those saves, and a
backward whose saves a later decode overwrote raises too.

Without graphs (``graphs=False``, the CPU) the same step bodies run
eagerly, T times each: the tests hold that reverse loop against autograd
through the eager loop.  ``usable`` says where ``models.tacotron`` takes
this path: CUDA tensors in f32, with no torch function or dispatch mode
active (a mode sees every call, which a replay does not make).
``DECODER_GRAPHS`` counts the graphs captured and the forward steps
replayed from one.
"""

from __future__ import annotations

import math
import weakref

import torch

from ..utils import tree_leaves, tree_map
from . import attention as ATT

# graphs captured (forward and backward each count one) and forward
# decoder steps replayed from a graph (``utils.metrics.counters()``)
DECODER_GRAPHS = {"captures": 0, "steps_replayed": 0}

# the attention state's fields packed after c1, h1, c2, h2: floats, then ints
ATT_FLOATS = ("context", "alignments", "cumulated", "alpha", "extra")
ATT_INTS = ("max_attention", "pos_rec")


class ArenaBusy(RuntimeError):
    """A decode would overwrite the saves of a forward whose backward has
    not run."""


def usable(memory: torch.Tensor) -> bool:
    """Whether a teacher-forced decode on ``memory`` replays graphs: CUDA,
    f32, and no torch function or dispatch mode intercepting calls."""
    if not memory.is_cuda or memory.dtype != torch.float32:
        return False
    from torch.overrides import _get_current_function_mode_stack
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return not _get_current_function_mode_stack() and _get_current_dispatch_mode() is None


def _widths(cfg, T_in: int, V: int) -> list:
    """Widths of the carry's float fields, packed in this order."""
    K = ATT.init_state(cfg, 1, 1, 1, "meta").extra.shape[1]
    U = cfg.decoder_lstm_units
    return [U, U, U, U, V, T_in, T_in, T_in, K]


def _pack(carry):
    a = carry.att
    floats = torch.cat([carry.c1, carry.h1, carry.c2, carry.h2] + [getattr(a, f) for f in ATT_FLOATS], dim=-1)
    return floats, torch.stack([getattr(a, f) for f in ATT_INTS], dim=-1)


def _unpack(floats: list, ints: torch.Tensor):
    from .tacotron import DecoderCarry

    att = ATT.AttentionState(*floats[4:], ints[:, 0], ints[:, 1])
    return DecoderCarry(*floats[:4], att)


class _Lease:
    """Held by the autograd node of a forward with gradients while the
    arena's slots hold its saves."""

    __slots__ = ("done", "__weakref__")

    def __init__(self):
        self.done = False


class _Arena:
    """The slots of every key on one device: one flat buffer per dtype,
    viewed by each key as its ``[T_cap (+1), B, ...]`` buffers."""

    def __init__(self, device):
        self.device = device
        self.t_cap = 0
        self.rows = {}  # dtype -> (elements a step, elements besides), the most any key asked for
        self.flat = {}  # dtype -> 1-D tensor of rows[0] * t_cap + rows[1] elements
        self.users = weakref.WeakSet()  # the keys' graphs viewing the slots
        self.owner = None  # weakref to the lease of the forward whose saves the slots hold

    def claim(self):
        held = None if self.owner is None else self.owner()
        if held is not None and not held.done:
            raise ArenaBusy("a graphed decode's backward has not run yet: run it (or free its graph) "
                            "before the next teacher-forced decode on this device")
        self.owner = None

    def reserve(self, T: int, layout: list) -> None:
        """Room for ``layout`` ((name, dtype, extra rows, row shape): T_cap +
        extra rows each) at T steps; if short, every user lets go of its
        views and graphs (which hold the old slots) and the slots grow."""
        need = {}
        for _, dtype, extra, shape in layout:
            a, b = need.get(dtype, (0, 0))
            need[dtype] = (a + math.prod(shape), b + extra * math.prod(shape))
        rows = {d: tuple(max(x, y) for x, y in zip(self.rows.get(d, (0, 0)), n)) for d, n in need.items()}
        if T <= self.t_cap and all(self.rows.get(d) == r for d, r in rows.items()):
            return
        for user in self.users:
            user.s, user.fwd, user.bwd = None, None, None
        self.t_cap = max(T, 2 * self.t_cap) if T > self.t_cap else self.t_cap
        self.rows.update(rows)
        for d, (a, b) in self.rows.items():
            self.flat[d] = None  # free before allocating the larger one
            self.flat[d] = torch.empty(a * self.t_cap + b, dtype=d, device=self.device)

    def views(self, layout: list) -> dict:
        off, out = {}, {}
        for name, dtype, extra, shape in layout:
            o = off.get(dtype, 0)
            n = (self.t_cap + extra) * math.prod(shape)
            out[name] = self.flat[dtype][o:o + n].view(self.t_cap + extra, *shape)
            off[dtype] = o + n
        return out


class _Weights:
    """Static copies of the decoder's weights (leaves that want a
    gradient) and their gradient accumulators, shared by the keys whose
    weights have the same shapes."""

    def __init__(self, leaves: list):
        self.leaves = [torch.empty_like(p, memory_format=torch.contiguous_format).requires_grad_(True)
                       for p in leaves]
        self.accs = [torch.zeros_like(p) for p in self.leaves]


class _Graphs:
    """The slots, static inputs, step counters and graphs of one key."""

    def __init__(self, arena: _Arena, weights: _Weights, cfg, train: bool, grad: bool, shapes: dict, tree: dict):
        self.arena, self.weights, self.cfg = arena, weights, cfg
        B, T_in, P, A, V = (shapes[k] for k in ("B", "T_in", "P", "A", "V"))
        U = cfg.decoder_lstm_units
        dev, f32 = arena.device, torch.float32
        self.sizes = _widths(cfg, T_in, V)
        self.out_sizes = [U, V, T_in]
        self.layout = [("xs", f32, 0, (B, P)), ("ys", f32, 0, (B, sum(self.out_sizes))),
                       ("cf", f32, 1, (B, sum(self.sizes))), ("ci", torch.int32, 1, (B, len(ATT_INTS)))]
        if shapes["zone"]:
            self.layout.append(("zm", torch.bool, 0, (B, 4, U)))
        if shapes["att"]:
            self.layout.append(("am", torch.bool, 0, (B, shapes["att"])))
        if grad:
            self.layout += [("gys", f32, 0, (B, sum(self.out_sizes))), ("gxs", f32, 0, (B, P))]
        self.same_keys = shapes["same_keys"]
        self.memory = torch.empty(B, T_in, V, device=dev)
        self.keys = self.memory if self.same_keys else torch.empty(B, T_in, A, device=dev)
        self.mask = torch.empty(B, T_in, device=dev)
        self.comb = [torch.empty(s, device=dev) for s in shapes["comb"]]  # w_comb, b_comb or nothing
        diff = ([] if self.same_keys else [self.keys]) + [self.memory] + self.comb
        for x in diff:
            x.requires_grad_(grad)
        self.diff = diff  # the static inputs that take a gradient, with their accumulators
        self.accs = [torch.zeros_like(x) for x in diff] if grad else []
        self.gc = torch.zeros(B, sum(self.sizes), device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.tb = torch.zeros(1, dtype=torch.long, device=dev)
        from .tacotron import decoder_step

        it = iter(weights.leaves)
        sp = tree_map(lambda _: next(it), tree)  # ``tree``'s structure over the static weights
        keys, memory, mask = self.keys, self.memory, self.mask
        wc, bc = self.comb if self.comb else (None, None)
        self.step = lambda carry, pre, zone, att: decoder_step(
            sp, cfg, None, carry, keys, memory, mask, None, wc, bc, train=train, zoneout_masks=zone,
            att_mask=att, pre=pre, project=False)
        self.s = self.fwd = self.bwd = None  # the slots' views and the graphs, bound at the first decode
        arena.users.add(self)

    # -- the step bodies: one step at the slot the device counter points to

    def _inputs(self, t):
        pre = self.s["xs"].index_select(0, t)[0]
        zone = att = None
        if "zm" in self.s:
            z = self.s["zm"].index_select(0, t)[0]
            zone = ((z[:, 0], z[:, 1]), (z[:, 2], z[:, 3]))
        if "am" in self.s:
            att = self.s["am"].index_select(0, t)[0]
        return pre, zone, att

    def _fwd_body(self):
        t = self.t
        floats = self.s["cf"].index_select(0, t)[0].split(self.sizes, dim=-1)
        carry = _unpack(list(floats), self.s["ci"].index_select(0, t)[0])
        out2, ctx, align, new = self.step(carry, *self._inputs(t))
        self.s["ys"].index_copy_(0, t, torch.cat([out2, ctx, align], dim=-1)[None])
        nf, ni = _pack(new)
        t1 = t + 1
        self.s["cf"].index_copy_(0, t1, nf[None])
        self.s["ci"].index_copy_(0, t1, ni[None])
        t.add_(1)

    def _bwd_body(self):
        t = self.tb
        with torch.enable_grad():
            fl = [v.detach().requires_grad_(True)
                  for v in self.s["cf"].index_select(0, t)[0].split(self.sizes, dim=-1)]
            carry = _unpack(fl, self.s["ci"].index_select(0, t)[0])
            pre, zone, att = self._inputs(t)
            pre = pre.detach().requires_grad_(True)
            out2, ctx, align, new = self.step(carry, pre, zone, att)
            outs = [out2, ctx, align, new.c1, new.h1, new.c2, new.h2] + [getattr(new.att, f) for f in ATT_FLOATS]
            cots = list(self.s["gys"].index_select(0, t)[0].split(self.out_sizes, dim=-1))
            cots += list(self.gc.split(self.sizes, dim=-1))
            pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
            ins = fl + [pre] + self.diff + self.weights.leaves
            grads = torch.autograd.grad([o for o, _ in pairs], ins, [c for _, c in pairs], allow_unused=True)
        n = len(fl)
        g_carry = [torch.zeros_like(x) if g is None else g for x, g in zip(fl, grads[:n])]
        self.gc.copy_(torch.cat(g_carry, dim=-1))
        g_pre = grads[n] if grads[n] is not None else torch.zeros_like(pre)
        self.s["gxs"].index_copy_(0, t, g_pre[None])
        for acc, g in zip(self.accs + self.weights.accs, grads[n + 1:]):
            if g is not None:
                acc.add_(g)
        t.sub_(1)

    # -- a decode

    def _capture(self, body, pool=None):
        """Warm ``body`` up once on a side stream, then capture it (into
        the memory pool of the graph ``pool`` if given, else its own)."""
        dev = self.arena.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=None if pool is None else pool.pool(), capture_error_mode="thread_local"):
            body()
        DECODER_GRAPHS["captures"] += 1
        return g

    def forward(self, T: int, pre_all, zone, att, keys, memory, mem_mask, comb, leaves, graphs: bool):
        self.arena.reserve(T, self.layout)
        if self.s is None:
            self.s = self.arena.views(self.layout)
        s = self.s
        with torch.no_grad():
            s["xs"][:T].copy_(pre_all)
            if zone is not None:
                for i, z in enumerate(zone):
                    s["zm"][:T, :, i].copy_(z)
            if att is not None:
                s["am"][:T].copy_(att)
            from .tacotron import init_decoder_carry

            B, T_in, V = memory.shape
            f0, i0 = _pack(init_decoder_carry(self.cfg, B, T_in, V, memory.device))
            s["cf"][0].copy_(f0)
            s["ci"][0].copy_(i0)
            if not self.same_keys:
                self.keys.copy_(keys)
            self.memory.copy_(memory)
            self.mask.copy_(mem_mask)
            for dst, src in zip(self.comb + self.weights.leaves, list(comb) + list(leaves)):
                dst.copy_(src)
            self.t.zero_()
            if graphs:
                if self.fwd is None:
                    self.fwd = self._capture(self._fwd_body)
                    self.t.zero_()
                for _ in range(T):
                    self.fwd.replay()
                DECODER_GRAPHS["steps_replayed"] += T
            else:
                for _ in range(T):
                    self._fwd_body()
            return tuple(y.clone() for y in s["ys"][:T].split(self.out_sizes, dim=-1))

    def backward(self, T: int, cots, graphs: bool):
        s = self.s
        with torch.no_grad():
            o = 0
            for c, w in zip(cots, self.out_sizes):
                s["gys"][:T, :, o:o + w].copy_(c)
                o += w
            self.tb.fill_(T - 1)
            if graphs and self.bwd is None:
                self.bwd = self._capture(self._bwd_body, self.fwd)  # its scratch and the forward's never overlap
                self.tb.fill_(T - 1)
            self.gc.zero_()
            for acc in self.accs + self.weights.accs:
                acc.zero_()
            for _ in range(T):
                self.bwd.replay() if graphs else self._bwd_body()
            g_diff = [a.clone() for a in self.accs]
            g_w = [a.clone() for a in self.weights.accs]
            return s["gxs"][:T].clone(), g_diff, g_w


_ARENAS: dict = {}  # device -> _Arena
_WEIGHTS: dict = {}  # (device, the leaves' shapes and dtypes) -> _Weights
_GRAPHS: dict = {}  # key -> _Graphs


class _GraphedDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs_of, T, graphs, pre_all, zone, att, keys, memory, mem_mask, w_comb, b_comb, *leaves):
        graphs_of.arena.claim()
        comb = [] if w_comb is None else [w_comb, b_comb]
        out = graphs_of.forward(T, pre_all, zone, att, keys, memory, mem_mask, comb, leaves, graphs)
        lease = _Lease()
        graphs_of.arena.owner = weakref.ref(lease)
        ctx.lease, ctx.graphs_of, ctx.T, ctx.graphs = lease, graphs_of, T, graphs
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out2, g_ctx, g_align):
        go = ctx.graphs_of
        owner = go.arena.owner
        if owner is None or owner() is not ctx.lease:
            raise ArenaBusy("a later decode overwrote this graphed decode's saves before its backward")
        g_pre, g_diff, g_w = go.backward(ctx.T, (g_out2, g_ctx, g_align), ctx.graphs)
        ctx.lease.done = True
        g_keys = None if go.same_keys else g_diff.pop(0)
        g_mem = g_diff.pop(0)
        g_wc, g_bc = g_diff if g_diff else (None, None)
        return (None, None, None, g_pre, None, None, g_keys, g_mem, None, g_wc, g_bc, *g_w)


def decode(params, cfg, train: bool, pre_all, zone, att, keys, memory, mem_mask, w_comb=None, b_comb=None,
           graphs: bool | None = None):
    """The teacher-forced loop over ``decoder_step`` (``pre`` given,
    ``project=False``) -> (out2 [T, B, U], context [T, B, V], aligns [T, B,
    T_in]), differentiable in ``pre_all`` [T, B, P], ``keys``, ``memory``,
    ``w_comb``/``b_comb`` and the leaves of ``params``' ``dec_lstm1``,
    ``dec_lstm2`` and ``attention``.  ``zone``: the four zoneout keep-masks
    (LSTM1 cell, hidden, LSTM2 cell, hidden), each [T, B, U], or None;
    ``att``: GMM's dropout keep-mask [T, B, Q] or None.  ``graphs``
    (default: on CUDA tensors) replays captured graphs; else the same step
    bodies run eagerly."""
    graphs = memory.is_cuda if graphs is None else graphs
    T, B, P = pre_all.shape
    T_in, V = memory.shape[1], memory.shape[2]
    tree = {k: params[k] for k in ("dec_lstm1", "dec_lstm2", "attention")}
    leaves = tree_leaves(tree)
    comb = [] if w_comb is None else [w_comb, b_comb]
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in [pre_all, keys, memory, *comb, *leaves])
    dev = memory.device
    shapes = {"B": B, "T_in": T_in, "P": P, "A": keys.shape[-1], "V": V, "zone": zone is not None,
              "att": 0 if att is None else att.shape[-1], "same_keys": keys is memory,
              "comb": tuple(tuple(c.shape) for c in comb)}
    wkey = (str(dev), tuple((tuple(p.shape), p.dtype) for p in leaves))
    flags = (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision)
    key = (wkey, cfg, train, grad, pre_all.dtype, flags, graphs, tuple(shapes.items()))
    go = _GRAPHS.get(key)
    if go is None:
        arena = _ARENAS.setdefault(str(dev), _Arena(dev))
        weights = _WEIGHTS.get(wkey)
        if weights is None:
            weights = _WEIGHTS[wkey] = _Weights(leaves)
        go = _GRAPHS[key] = _Graphs(arena, weights, cfg, train, grad, shapes, tree)
    zone = None if zone is None else tuple(zone)
    if grad:
        return _GraphedDecode.apply(go, T, graphs, pre_all, zone, att, keys, memory, mem_mask, w_comb, b_comb,
                                    *leaves)
    go.arena.claim()
    return go.forward(T, pre_all, zone, att, keys, memory, mem_mask, comb, leaves, graphs)
