"""Radix prefix index over the pool's content-hashed pages.

The port of ``repro/serve/prefix_cache.py`` (the port imports nothing of
that package). The `PagedKVPool` dedups *stored*
pages by cumulative token-prefix hash, but only while some live sequence
holds a reference: a retired request's prompt pages die with it.
`RadixPrefixCache` turns the pool into a cross-request cache: the tree
*pins* every full prompt page it has seen (one pool reference per node
page), so a new request walks its prompt's cumulative page hashes, adopts
the longest cached page-aligned prefix — including prefixes whose owners
retired long ago — and prefills only the suffix.

Hashes are cumulative (hash p covers ``tokens[:(p + 1) * t]``), so a node
is identified by its page hash and matching is successive dict lookups;
the parent/child links exist for leaf-first eviction.

Pinning and eviction rules (the scheduler's budget relies on them):

- Each node holds exactly ONE pool reference per layer page of its group.
  Destroying a node drops those references; pages whose last holder was
  the tree are destroyed and their device slots recycled via
  ``on_release``.
- Eviction is leaf-first in LRU order and only touches *exclusive* nodes,
  whose every page is held by the tree alone (``refs == 1``): a page some
  live sequence adopted is never evicted from under it, nor (adoption
  takes the whole prefix path) any of its ancestors.
- A mesh-sharded pool keeps one tree root PER data shard: a sequence
  bound to shard s only matches and inserts in shard s's tree, so
  adoption never references a page whose device slot lives on another
  shard. Every method takes the shard as ``shard=`` (default 0).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


class _Node:
    """One cached full prompt page: its cumulative hash, the per-layer
    pool page ids it pins, and the tree links for leaf-first eviction."""

    __slots__ = ("hash", "group", "parent", "children", "last_access")

    def __init__(self, h: str, group: tuple, parent: Optional["_Node"]):
        self.hash = h
        self.group = group                  # per-layer pool pids
        self.parent = parent
        self.children: dict[str, "_Node"] = {}
        self.last_access = 0


@dataclasses.dataclass
class PrefixMatch:
    """Longest cached page-aligned prefix of one prompt on one shard:
    ``groups[p]`` is the per-layer pid tuple of prompt page p, ``hashes``
    the matched node hashes (protected from eviction while the admission
    that looked them up is being budgeted)."""
    groups: list
    hashes: list
    shard: int = 0

    @property
    def pages(self) -> int:
        return len(self.groups)


class RadixPrefixCache:
    """Per-data-shard radix index of pinned prompt pages over one pool.

    ``on_release(pid)`` is called for every pool page the tree's unpin
    destroyed — the serving state hooks it to recycle the page's device
    slot, as `PagedKVState.free_seq` does for sequence pages."""

    def __init__(self, pool, num_layers: int,
                 on_release: Optional[Callable[[int], None]] = None,
                 shards: int = 1):
        self.pool = pool
        self.num_layers = num_layers
        self.on_release = on_release
        self.shards = max(1, shards)
        self._roots = [_Node("", (), None) for _ in range(self.shards)]
        self._nodes: list[dict[str, _Node]] = [{} for _ in
                                               range(self.shards)]
        self._clock = 0
        self.stats = {"inserted": 0, "evicted": 0, "hits": 0, "misses": 0}

    # -- inspection ----------------------------------------------------------
    def nodes(self, shard: int = 0) -> int:
        return len(self._nodes[shard])

    def pinned_pages(self, shard: int = 0) -> int:
        """Pool pages `shard`'s tree holds references on (one per layer
        per node) — the scheduler counts them against the shard's budget
        because no active request's reservation covers them."""
        return len(self._nodes[shard]) * self.num_layers

    def pin_counts(self) -> dict[int, int]:
        """page id -> tree references held on it: the ``pins`` argument
        of `PagedKVPool.check_invariants`, over every shard's tree."""
        out: dict[int, int] = {}
        for nodes in self._nodes:
            for node in nodes.values():
                for pid in node.group:
                    out[pid] = out.get(pid, 0) + 1
        return out

    def _exclusive(self, node: _Node) -> bool:
        """True when the tree is the only holder of every page of the
        node's group — the only nodes eviction may destroy."""
        return all(self.pool.pages[pid].refs == 1 for pid in node.group)

    def reclaimable_pages(self, protect: frozenset = frozenset(),
                          shard: int = 0) -> int:
        """Pages eviction could free right now: exclusive, unprotected
        nodes whose whole subtree is reclaimable too (a node above a
        protected or shared descendant must stay to keep the path
        walkable)."""
        out = 0
        for node in self._nodes[shard].values():
            if node.hash in protect or not self._exclusive(node):
                continue
            if self._subtree_blocked(node, protect):
                continue
            out += self.num_layers
        return out

    def _subtree_blocked(self, node: _Node, protect) -> bool:
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.hash in protect or not self._exclusive(n):
                return True
            stack.extend(n.children.values())
        return False

    # -- insert / match ------------------------------------------------------
    def insert(self, page_hashes: list, shard: int = 0) -> int:
        """Pin a completed prompt's full pages in `shard`'s tree. The walk
        extends only while the pool stores a hashed page at every layer.
        Returns the number of NEW nodes pinned."""
        self._clock += 1
        node = self._roots[shard]
        created = 0
        for h in page_hashes:
            child = node.children.get(h)
            if child is None:
                group = tuple(self.pool.page_by_hash(l, h)
                              for l in range(self.num_layers))
                if any(pid is None for pid in group):
                    break
                child = _Node(h, group, node)
                for pid in group:
                    self.pool.ref_page(pid)
                node.children[h] = child
                self._nodes[shard][h] = child
                created += 1
                self.stats["inserted"] += 1
            child.last_access = self._clock
            node = child
        return created

    def match(self, page_hashes: list, limit: Optional[int] = None,
              shard: int = 0) -> PrefixMatch:
        """Longest cached page-aligned prefix of `page_hashes` in
        `shard`'s tree, capped at
        `limit` pages (admission caps at ``(prompt_len - 1) //
        page_tokens`` so at least one suffix token is left to produce the
        first token's logits). Touches the path."""
        self._clock += 1
        node = self._roots[shard]
        groups, hashes = [], []
        cap = len(page_hashes) if limit is None else min(limit,
                                                         len(page_hashes))
        for h in page_hashes[:cap]:
            child = node.children.get(h)
            if child is None:
                break
            child.last_access = self._clock
            groups.append(child.group)
            hashes.append(h)
            node = child
        self.stats["hits" if groups else "misses"] += 1
        return PrefixMatch(groups=groups, hashes=hashes, shard=shard)

    # -- eviction ------------------------------------------------------------
    def _destroy(self, node: _Node, shard: int):
        del self._nodes[shard][node.hash]
        node.parent.children.pop(node.hash, None)
        for pid in node.group:
            for dead_pid, _layer in self.pool.unref_page(pid):
                if self.on_release is not None:
                    self.on_release(dead_pid)
        self.stats["evicted"] += 1

    def make_room(self, pages: int, protect: frozenset = frozenset(),
                  shard: int = 0) -> int:
        """Evict leaf-first in LRU order until `pages` pool pages of
        `shard`'s pins are released (or nothing evictable is left). Only
        exclusive, unprotected leaves go; evicting a leaf may expose its
        parent. Returns the pages released."""
        freed = 0
        while freed < pages:
            victim = None
            for node in self._nodes[shard].values():
                if node.children or node.hash in protect \
                        or not self._exclusive(node):
                    continue
                if victim is None or node.last_access < victim.last_access:
                    victim = node
            if victim is None:
                break
            self._destroy(victim, shard)
            freed += self.num_layers
        return freed

    def clear(self):
        """Release every pin on every shard (session teardown): pages
        whose last holder was the tree are destroyed, so a closed session
        leaves ``pool.live_pages == 0``."""
        for shard in range(self.shards):
            while self._nodes[shard]:
                leaf = next(n for n in self._nodes[shard].values()
                            if not n.children)
                self._destroy(leaf, shard)
            self._roots[shard].children.clear()
