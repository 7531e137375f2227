"""CUDA-graph capture of fixed-shape work: the port's one mechanism.

A user is a :class:`GraphCache` of :class:`Captured` entries, one a key
(everything that shapes the captured work). An entry holds static buffers
that each call's tensors are loaded into, :class:`Chain` s of graphs that
read them, and :func:`own`, the rule for what the caller may keep of the
outputs. The users are the tracker's tick and its RANSAC PnP solve; this
module knows neither. A tree is tuples, NamedTuples and dicts of tensors,
None and numbers.
"""

from __future__ import annotations

import threading

import torch


def _leaves(tree, out: list | None = None) -> list:
    """A tree's leaves, in order."""
    out = [] if out is None else out
    if isinstance(tree, (tuple, dict)):
        for x in tree.values() if isinstance(tree, dict) else tree:
            _leaves(x, out)
    else:
        out.append(tree)
    return out


def _paths(tree, path: str = "") -> list[str]:
    """Each leaf's name, in :func:`_leaves`' order: fields joined by dots."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(getattr(tree, "_fields", None) or map(str, range(len(tree))), tree)
    else:
        return [path]
    return [p for name, x in items for p in _paths(x, f"{path}.{name}" if path else name)]


def map_tree(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, x) for k, x in tree.items()}
    if isinstance(tree, tuple):
        items = [map_tree(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree)


def storages(tree) -> set[int]:
    """The storage addresses of a tree's tensors."""
    return {t.untyped_storage().data_ptr() for t in _leaves(tree) if isinstance(t, torch.Tensor)}


def own(tree, callers: dict[int, torch.Tensor], graph: set[int]):
    """``tree`` as the caller may keep it: a static buffer (``callers`` maps
    its ``id`` to the tensor it was loaded from) becomes the caller's own
    tensor; a tensor whose storage is in ``graph`` (static buffers, graph
    outputs) a clone, one per tensor, so that aliases stay aliases;
    anything else (eager work after the graphs) itself."""
    clones: dict[int, torch.Tensor] = {}

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) in callers:
            return callers[id(t)]
        if t.untyped_storage().data_ptr() not in graph:
            return t
        if id(t) not in clones:
            clones[id(t)] = t.clone()
        return clones[id(t)]

    return map_tree(one, tree)


class Chain:
    """A function captured as CUDA graphs that replay in order, broken at
    each call of the eager launch it takes as its one argument. On replay
    the launch runs between two graphs on the same static arguments, and
    its result is copied where the next graph reads it; so a hand-written
    kernel's launcher runs on every replay, as in the eager function.

    The capture warms up on a side stream with ``placeholder`` for the
    launch (outputs of its shapes, no kernel), then captures
    (``thread_local``: other threads keep working), every graph of the
    chain from one pool.
    """

    def __init__(self, placeholder=None) -> None:
        self.placeholder = placeholder
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.breaks: list[tuple[tuple, tuple]] = []  # (arguments, static outputs) after graph i
        self.outputs = None
        self._pool = None

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        self.graphs.append(graph)

    def _break(self, *args):
        """The launch's place in the capture: close the graph, keep the
        arguments and static outputs for the replay, open the next."""
        self.graphs[-1].capture_end()
        static = self.placeholder(*args)
        self.breaks.append((args, static))
        self._begin()
        return static

    def capture(self, fn, device: torch.device) -> None:
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(device), torch.cuda.stream(side):
            fn(self.placeholder)  # lazy handles and workspaces come up on this stream
            side.synchronize()
            self._begin()
            try:
                self.outputs = fn(self._break)
            finally:
                self.graphs[-1].capture_end()
        current.wait_stream(side)

    def replay(self, launch=None):
        """The graphs in order, ``launch`` at each break; a dry replay (no
        ``launch``) leaves the breaks' outputs as they are."""
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if launch is not None and i < len(self.breaks):
                args, static = self.breaks[i]
                for dst, src in zip(static, launch(*args)):
                    dst.copy_(src)
        return self.outputs


class Captured:
    """One key's capture on ``device``: ``chains`` :class:`Chain` s, static
    buffers by name (``"inputs"`` shaped as ``inputs``, any other as the
    tree of its first :meth:`load`), and the ``free`` event recorded once
    the last call's outputs were owned."""

    def __init__(self, device: torch.device, inputs, chains: int = 1, placeholder=None) -> None:
        self.device = device
        self.chains = [Chain(placeholder) for _ in range(chains)]
        self.free: torch.cuda.Event | None = None
        self._static: dict[str, tuple] = {}
        self._storages: set[int] = set()
        self._callers: dict[int, torch.Tensor] = {}
        self._make("inputs", inputs)

    def _make(self, name: str, tree) -> None:
        buffers = map_tree(lambda t: None if t is None else torch.empty_like(t, device=self.device), tree)
        self._static[name] = buffers, _leaves(buffers)
        self._storages |= storages(buffers)

    def load(self, name: str, tree):
        """``tree`` into the buffers ``name`` on the current stream, after
        the last call's outputs are owned; returns the buffers. A tensor
        must have its buffer's shape and dtype (else ``ValueError`` naming
        the field) and is copied without a wait (pinned host tensors too);
        a number fills its buffer; None leaves it as it is."""
        if name not in self._static:
            self._make(name, tree)
        buffers, flat = self._static[name]
        if self.free is not None:
            torch.cuda.current_stream(self.device).wait_event(self.free)
        for k, (dst, src) in enumerate(zip(flat, _leaves(tree))):
            if dst is None or src is None:
                continue
            if not isinstance(src, torch.Tensor):
                dst.fill_(src)
                continue
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"{_paths(tree)[k]} must be {tuple(dst.shape)} {dst.dtype}, "
                                 f"got {tuple(src.shape)} {src.dtype}")
            dst.copy_(src, True)  # non_blocking, by position: this loop runs every tick
            self._callers[id(dst)] = src
        return buffers

    def run(self, chain: Chain, fn, launch=None) -> str:
        """:meth:`Chain.replay`, capturing ``fn`` on the chain's first call;
        returns the mode, ``"capture"`` or ``"replay"``."""
        mode = "replay"
        if not chain.graphs:
            chain.capture(fn, self.device)
            self._storages |= storages((chain.outputs, *(static for _, static in chain.breaks)))
            mode = "capture"
        chain.replay(launch)
        return mode

    def own(self, tree):
        """:func:`own` on this entry's buffers and graphs; records ``free``."""
        owned = own(tree, self._callers, self._storages)
        self._callers.clear()
        if self.free is None:
            self.free = torch.cuda.Event()
        self.free.record(torch.cuda.current_stream(self.device))
        return owned


class GraphCache:
    """:class:`Captured` entries by key behind one lock, and how many were
    captured (:attr:`captures`)."""

    def __init__(self) -> None:
        self._entries: dict[tuple, Captured] = {}
        self._lock = threading.Lock()
        self.captures = 0

    def dispatch(self, key: tuple, device: torch.device, eager, make, replay):
        """``eager()`` off the card (its spans say ``"eager"``); else, under
        the lock, ``replay(entry)`` on the key's entry, which ``make()``
        makes on the key's first call."""
        if device.type != "cuda":
            return eager()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                return replay(entry)
            entry = make()
            out = replay(entry)
            self._entries[key] = entry
            self.captures += 1
            return out
