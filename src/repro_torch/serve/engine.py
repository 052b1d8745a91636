"""Serving engine of the port: chunked-prefill continuous batching over a
dense or paged (block-table) KV cache, with content-addressed prefix
sharing and copy-on-write pages, sliding-window ring pools of their own,
and stateful failover (verified export / import of a live request) —
the counterpart of ``repro.serve.engine`` for full-attention (GQA or
MLA), sliding-window, RWKV6 and Mamba-hybrid models, with dense or MoE
FFNs.

One step function (``make_engine_step``) serves both chunked prefill
(S = chunk) and the batched decode tick (S = 1).  Only the last position
is unembedded, and the token is chosen inside the step: greedy argmax,
repetition penalty and temperature / top-p / top-k sampling.  The JAX
version's ``lax.cond`` gates are host-side ``if``s on the engine's numpy
sampling arrays here, so an all-greedy tick runs no penalty or sampling
work.  Nothing inside a step's forward pass waits for the device; a
decode tick reads the next tokens of every slot in one device-to-host
copy at its end, not one ``int()`` per slot.

Sampling draws JAX's threefry bits (``repro_torch.prng``) from the
same per-slot counter keys (seed + slot, step counter) as the JAX engine,
on the logits' device for every sampled slot at once, so sampled tokens
are JAX's token for token.

``make_prefill_step`` / ``make_decode_step`` are the counterparts of the
JAX engine's prefill and single-token decode functions; ``generate``
runs them.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, device_of, prng, resolve_device
from repro_torch.models.config import ATTN, MAMBA, RWKV, SWA, ModelConfig
from repro_torch.models.layers import NEG_INF, swa_ring_blocks
from repro_torch.models import hints
from repro_torch.models.transformer import (check_ported, forward, init_cache,
                                            unembed)

# pool leaves of paged attention-family caches (block-indexed, shared
# across slots; MLA's latent pools are "ckv" / "krope"); everything else
# in a cache tree is per-slot state
POOL_LEAVES = ("k", "v", "pos", "ckv", "krope")


def make_prefill_step(cfg: ModelConfig, *, kv_chunk: int = 1024):
    """(params, caches, batch, positions) -> (last-token logits (B,1,V),
    caches).  batch carries (B, S_prompt) tokens (and / or stub
    embeddings); the caches are written in place."""
    def prefill_step(params, caches, batch, positions):
        logits, _, caches = forward(params, cfg, batch, caches=caches,
                                    positions=positions, kv_chunk=kv_chunk)
        return logits[:, -1:, :], caches
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, kv_chunk: int = 1024):
    """(params, caches, batch with (B,1) tokens | embeds, positions (B,1))
    -> (logits (B,1,V), caches): one new token against the running cache.
    (Continuous batching goes through ``make_engine_step``.)"""
    def decode_step(params, caches, batch, positions):
        logits, _, caches = forward(params, cfg, batch, caches=caches,
                                    positions=positions, decode=True,
                                    kv_chunk=kv_chunk)
        return logits, caches
    return decode_step


def topp_sample(keys: torch.Tensor, logits: torch.Tensor,
                temperature: torch.Tensor, top_p: torch.Tensor,
                top_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row temperature + nucleus (+ optional top-k) sampling, as
    ``repro.serve.engine.topp_sample``.

    keys: (B, 2) raw threefry keys (uint32 words in an integer tensor),
    each row's draw JAX's ``vmap(categorical)``; or (B, V) float uniforms
    in [0, 1) already drawn.  logits: (B, V) f32; temperature / top_p:
    (B,) f32; top_k: (B,) int, 0 = no cut.  Each row samples
    (Gumbel-argmax) from the smallest prefix of its sorted distribution
    whose mass reaches top_p, intersected with its top_k highest logits;
    the top token always stays, so top_p -> 0 or top_k == 1 is greedy.
    Returns (B, 1) int32."""
    V = logits.shape[-1]
    lg = logits / temperature.clamp(min=1e-6)[:, None]
    order = torch.argsort(-lg, dim=-1, stable=True)
    slg = torch.gather(lg, -1, order)
    probs = torch.softmax(slg, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    if top_k is not None:
        k_eff = torch.where(top_k > 0, top_k, V)
        keep &= torch.arange(V, device=logits.device)[None, :] < k_eff[:, None]
    slg = torch.where(keep, slg, NEG_INF)
    if keys.is_floating_point():
        idx = torch.argmax(prng.gumbel_from_uniform(keys) + slg, dim=-1)
    else:
        idx = prng.categorical(keys, slg)
    return torch.gather(order, -1, idx[:, None]).to(torch.int32)


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             rep_penalty: torch.Tensor) -> torch.Tensor:
    """CTRL-style repetition penalty per row: logits of tokens the row has
    seen are divided by the penalty when positive and multiplied when
    negative.  Rows with penalty 1.0 come back bitwise-untouched."""
    pen = rep_penalty[:, None]
    scaled = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen & (pen != 1.0), scaled, logits)


def make_engine_step(cfg: ModelConfig, *, kv_chunk: int = 1024,
                     paged: bool = False, use_kernel: bool = False):
    """(params, caches, seen (B,V) bool, tokens (B,S), positions (B,S),
    table (B,n_cols), rng_keys (B,2) uint32, temperature (B,), top_p (B,),
    top_k (B,), rep_penalty (B,)) -> (next-token ids (B,1) int32, caches,
    seen).

    tokens / positions / table are device tensors; the sampling operands
    are the engine's host numpy arrays, so the penalty and sampling
    branches are decided on the host without a device sync.  Rows with
    position -1 are cache no-ops.  ``caches`` and ``seen`` are updated in
    place.  ``use_kernel=True`` runs each mixer's Hopper kernel where the
    port has one: paged S=1 decode attention and the Mamba and RWKV
    recurrences."""
    def engine_step(params, caches, seen, tokens, positions, table,
                    rng_keys, temperature, top_p, top_k, rep_penalty):
        B = tokens.shape[0]
        dev = tokens.device
        penalize = bool(np.any(rep_penalty != 1.0))
        hot = np.nonzero(temperature > 0.0)[0]
        # the sampled rows' keys and settings go to the device before the
        # forward is queued, so the copies wait on no device work
        sampled = None if not len(hot) else [
            torch.from_numpy(a).to(dev) for a in (
                hot, rng_keys[hot].astype(np.int64), temperature[hot],
                top_p[hot], top_k[hot])]
        if penalize:
            ok = positions >= 0
            rows = torch.arange(B, device=dev)[:, None].expand_as(tokens)
            seen[rows[ok], tokens[ok].long()] = True
        h, _, caches = forward(params, cfg, {"tokens": tokens},
                               caches=caches, positions=positions,
                               decode=tokens.shape[1] == 1,
                               kv_chunk=kv_chunk, compute_logits=False,
                               masked_slots=True,
                               block_table=table if paged else None,
                               use_kernel=use_kernel)
        lg = unembed(params, cfg, h[:, -1:, :])[:, 0, :]
        if penalize:
            lg = apply_repetition_penalty(
                lg, seen, torch.from_numpy(rep_penalty).to(dev))
        lg = hints.unsplit(lg, -1)       # the vocabulary whole per rank
        tok = torch.argmax(lg, dim=-1, keepdim=True).to(torch.int32)
        if sampled is not None:
            idx, keys, temp, p, k = sampled
            tok[idx] = topp_sample(keys, lg[idx], temp, p, k)
        return tok, caches, seen
    return engine_step


def sample(logits: torch.Tensor, key: torch.Tensor,
           temperature: float = 0.0) -> torch.Tensor:
    """logits (B,1,V) f32 -> tokens (B,1) int32: greedy at temperature
    0, else ``jax.random.categorical(key, logits / temperature)``'s draw
    (``key``: one raw (2,) key)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prng.categorical(key, logits / temperature).to(torch.int32)


def generate(params: dict, cfg: ModelConfig, prompts, *, max_new: int,
             cache_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0) -> torch.Tensor:
    """Batched generation on the parameters' device (the reference the
    engine tests compare against): greedy at temperature 0, else sampled
    with JAX's key sequence (``PRNGKey(seed)`` for the first token, then
    ``key, sub = split(key)`` before each decode step, the key chain kept
    on the host).  prompts: (B, S) int.  Returns (B, S + max_new) int32."""
    dev = device_of(params)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    B, S0 = prompts.shape
    caches = init_cache(cfg, B, cache_len or (S0 + max_new), device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    pos = torch.arange(S0, dtype=torch.int32, device=dev)[None].expand(B, S0)
    logits, caches = prefill(params, caches, {"tokens": prompts}, pos)
    key = prng.PRNGKey(seed)
    out = [prompts]
    tok = sample(logits, key, temperature)
    for t in range(max_new):
        out.append(tok)
        if t == max_new - 1:
            break
        key, sub = prng.split(key)
        posd = torch.full((B, 1), S0 + t, dtype=torch.int32, device=dev)
        logits, caches = decode(params, caches, {"tokens": tok}, posd)
        tok = sample(logits, sub, temperature)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Slot-based continuous batcher
# ---------------------------------------------------------------------------

@dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0     # 0 -> greedy
    top_p: float = 1.0
    top_k: int = 0               # 0 -> no top-k cut
    rep_penalty: float = 1.0     # 1.0 -> no repetition penalty
    generated: List[int] = field(default_factory=list)
    pending: int = -1            # next token to feed/emit
    done: bool = False
    # chain digests of the prompt's full prefix pages, stamped by
    # drain_requests / export_state so a requeue keeps its prefix identity
    # for the router's affinity tie-break (None until then)
    prefix_digests: Optional[List[int]] = None
    # fleet lifecycle (serve.router.FleetRouter): fault-caused requeues
    # from the prompt count against max_retries; outcome is stamped once
    # when the request leaves the fleet ("ok" | "failed_retries" |
    # "failed_unservable" | "deadline_exceeded")
    retries: int = 0
    max_retries: int = 3
    outcome: Optional[str] = None
    # snapshot restore: tokens already decoded at the router's last
    # snapshot; admission prefills prompt + resume as one prompt and
    # restores ``generated`` from it
    resume_tokens: Optional[List[int]] = None


class BlockAllocator:
    """Host-side free list over a paged pool, reference-counted and
    content-addressed, as ``repro.serve.engine.BlockAllocator``.

    Admission reserves a request's worst case up front; ``alloc_one``
    takes a page against a reservation at refcount 1, ``share`` bumps a
    page another slot's table now references, and ``free`` drops one
    reference per block and returns the blocks whose count reached zero
    — only those are back on the free list, and the caller scrubs them.
    ``register`` / ``lookup`` map a prefix-page digest to its block,
    verified by a check value (parent block + exact tokens), so a digest
    collision is a miss, never wrong content.

    ``hold_limit`` > 0 keeps up to that many refcount-zero registered
    pages resident (LRU hold) so a readmitted prefix attaches them; they
    count as capacity, a reservation that needs them evicts the oldest
    first, and evicted pages land on ``take_scrub()`` for the engine to
    zero.  ``withheld`` pages (pool pressure) are kept from new
    reservations only."""

    def __init__(self, num_blocks: int, hold_limit: int = 0):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self.reserved = 0
        self.withheld = 0
        self.hold_limit = hold_limit
        self._held: List[int] = []                 # LRU, oldest first
        self._pending_scrub: List[int] = []
        self.refcount: Dict[int, int] = {}
        self._by_digest: Dict[int, int] = {}       # digest -> block
        self._entries: Dict[int, tuple] = {}       # block -> (digest, check)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_held(self) -> int:
        return len(self._held)

    def can_reserve(self, n: int) -> bool:
        return self.n_free + self.n_held - self.reserved - self.withheld >= n

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` future pages; False = backpressure.  Held pages
        the reservation needs are evicted, oldest first."""
        if not self.can_reserve(n):
            return False
        short = n - (self.n_free - self.reserved - self.withheld)
        if short > 0:
            self.evict_held(short)
        self.reserved += n
        return True

    def evict_held(self, k: int) -> List[int]:
        """Evict up to ``k`` oldest held pages to the free list
        (deregistered, queued on ``take_scrub``)."""
        out: List[int] = []
        for _ in range(max(0, min(k, len(self._held)))):
            b = self._held.pop(0)
            self.deregister(b)
            self._free.append(b)
            self._pending_scrub.append(b)
            out.append(b)
        return out

    def take_scrub(self) -> List[int]:
        """Blocks evicted from the hold since the last call: free-listed
        with stale content, for the caller to scrub."""
        out, self._pending_scrub = self._pending_scrub, []
        return out

    def alloc_one(self) -> int:
        """Take one page against an existing reservation (refcount 1)."""
        if not self._free or self.reserved <= 0:
            raise RuntimeError("BlockAllocator: alloc_one without a "
                               "backed reservation")
        self.reserved -= 1
        b = self._free.pop()
        self.refcount[b] = 1
        return b

    def share(self, block: int) -> None:
        """Another table row now references ``block``; a held page comes
        back out of the hold at refcount 1."""
        if not self.refcount.get(block, 0) and block in self._held:
            self._held.remove(block)
            self.refcount[block] = 1
            return
        if self.refcount.get(block, 0) <= 0:
            raise RuntimeError(f"BlockAllocator: share of unheld block {block}")
        self.refcount[block] += 1

    def lookup(self, digest: int, check: tuple) -> Optional[int]:
        """The resident block of a prefix-page digest, or None on a miss
        or a verified collision (check mismatch)."""
        b = self._by_digest.get(digest)
        if b is None or self._entries[b][1] != check:
            return None
        return b

    def register(self, digest: int, check: tuple, block: int) -> bool:
        """Advertise ``block`` as holding prefix page ``digest``; the
        first registration wins."""
        if digest in self._by_digest or block in self._entries:
            return False
        self._by_digest[digest] = block
        self._entries[block] = (digest, check)
        return True

    def deregister(self, block: int) -> None:
        ent = self._entries.pop(block, None)
        if ent is not None:
            self._by_digest.pop(ent[0], None)

    def is_registered(self, block: int) -> bool:
        return block in self._entries

    def free(self, blocks: List[int], unreserve: int = 0) -> List[int]:
        """Drop one reference per listed block; returns the blocks whose
        refcount reached zero and went back on the free list (to be
        scrubbed).  A registered page under a ``hold_limit`` is held
        instead, content intact, and not returned."""
        freed: List[int] = []
        for b in blocks:
            rc = self.refcount.get(b, 0)
            if rc <= 0:
                raise RuntimeError(f"BlockAllocator: double free of [{b}]")
            if rc == 1:
                del self.refcount[b]
                if self.hold_limit > 0 and self.is_registered(b):
                    self._held.append(b)
                    self.evict_held(len(self._held) - self.hold_limit)
                else:
                    self.deregister(b)
                    self._free.append(b)
                    freed.append(b)
            else:
                self.refcount[b] = rc - 1
        self.reserved -= unreserve
        if self.reserved < 0 or self.n_free > self.num_blocks:
            raise RuntimeError("BlockAllocator: accounting went negative")
        return freed


def _cache_leaves(caches):
    """(top, layer index, leaf name, slot/block axis, tensor) for every
    cache leaf: prefix layers are (slots|blocks, ...), stack layers carry
    a leading n_periods axis first.  ``top`` and the index name the
    layer's spec, so a leaf is routed by structure, never by shape."""
    for top, layers in caches.items():
        axis = 1 if top == "stack" else 0
        for idx, layer in enumerate(layers):
            for name, leaf in layer.items():
                yield top, idx, name, axis, leaf


def _pool_mixer(cfg: ModelConfig, top: str, idx: int) -> str:
    """Mixer kind of the layer owning a cache leaf ("attn", "swa", ...):
    sliding-window pools have their own block-id space."""
    specs = cfg.prefix_layers if top == "prefix" else cfg.period
    return specs[idx].mixer


def _path_key(top: str, idx: int, name: str) -> str:
    """The JAX package's key of a cache leaf ("stack/0/k", "prefix/3/v"),
    the index of migration payloads."""
    return f"{top}/{idx}/{name}"


def _clear_slot(caches, s: int, skip_pools: bool = False):
    """Zero slot ``s`` in every per-slot cache leaf (positions to -1;
    Mamba ``h`` / ``conv`` and RWKV ``state`` / ``shift`` to 0), in place.  ``skip_pools=True``
    (paged engines) leaves block pools alone: they are indexed by block
    id, and recycled blocks are scrubbed by ``make_clear_blocks``
    instead."""
    for _, _, name, axis, leaf in _cache_leaves(caches):
        if skip_pools and name in POOL_LEAVES:
            continue
        leaf[(slice(None),) * axis + (s,)] = -1 if name == "pos" else 0
    return caches


def make_clear_blocks(cfg: ModelConfig):
    """(caches, blocks, blocks_swa=()) -> caches: scrub the given pool
    blocks in every paged leaf (keys / values 0, positions -1), in place,
    so a recycled block never leaks a stale key into its next owner.
    Full-attention pools take ``blocks``, sliding-window pools
    ``blocks_swa``: the two block-id spaces are disjoint pools."""
    check_ported(cfg)

    def clear_blocks(caches, blocks, blocks_swa=()):
        for top, idx, name, axis, leaf in _cache_leaves(caches):
            if name not in POOL_LEAVES:
                continue
            ids = (blocks_swa if _pool_mixer(cfg, top, idx) == SWA
                   else blocks)
            if len(ids):
                ids = torch.as_tensor(ids, dtype=torch.long,
                                      device=leaf.device)
                leaf[(slice(None),) * axis + (ids,)] = -1 if name == "pos" else 0
        return caches
    return clear_blocks


def _copy_block(caches, src: int, dst: int):
    """Copy-on-write: duplicate pool page ``src`` into ``dst`` in every
    paged leaf (keys, values, positions), in place.  Only engines whose
    pools are all full-attention share pages, so no per-kind routing."""
    for _, _, name, axis, leaf in _cache_leaves(caches):
        if name in POOL_LEAVES:
            pre = (slice(None),) * axis
            leaf[pre + (dst,)] = leaf[pre + (src,)]
    return caches


# ---------------------------------------------------------------------------
# Stateful failover: migration payloads
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a host numpy array: bfloat16 as uint16 (numpy
    has no bfloat16; the bytes are those of JAX's bfloat16 arrays), other
    dtypes as themselves.  On the CPU the array shares ``t``'s storage,
    so ``t`` must be a copy (``make_gather_blocks`` makes one)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_to_host`` for a leaf of ``like``'s dtype."""
    a = np.ascontiguousarray(a)
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(like.dtype)
    return t.to(like.device)


@dataclass
class RequestState:
    """A live request's complete decode state, made by
    ``ServingEngine.export_state`` for verified migration to another
    replica (``import_state``), as ``repro.serve.engine.RequestState``.

    ``pool`` / ``slot_state`` map the JAX package's path keys ("stack/0/k")
    to host numpy arrays of the leaves' bits (bfloat16 as uint16): each
    pool entry holds the request's pages of one paged leaf (rows ordered
    like ``cols`` / ``cols_swa``), each slot_state entry one per-slot
    carry.  ``digests`` is the prompt's chain-digest trail, which the
    importer dedups against its own registry.  ``checksum`` chains crc32
    over the tokens, the position and every payload array; the importer
    recomputes it and rejects the whole transfer on a mismatch."""
    req: Request
    position: int
    fingerprint: tuple
    cols: List[int]                    # attn table columns, export order
    cols_swa: List[int]                # swa ring columns, export order
    pool: Dict[str, np.ndarray]
    slot_state: Dict[str, np.ndarray]
    digests: List[int]
    checksum: int
    payload_bytes: int


def state_checksum(state: RequestState) -> int:
    """Chained crc32 over a migration payload — tokens, position, then
    every payload array in sorted-key order (the JAX package's chain over
    the same bytes).  One flipped byte breaks it."""
    req = state.req
    c = zlib.crc32(np.asarray(req.prompt, np.int64).tobytes())
    c = zlib.crc32(np.asarray(req.generated + [req.pending],
                              np.int64).tobytes(), c)
    c = zlib.crc32(np.int64(state.position).tobytes(), c)
    for key in sorted(state.pool):
        c = zlib.crc32(np.ascontiguousarray(state.pool[key]).tobytes(), c)
    for key in sorted(state.slot_state):
        c = zlib.crc32(np.ascontiguousarray(state.slot_state[key]).tobytes(),
                       c)
    return c


def make_gather_blocks(cfg: ModelConfig):
    """(caches, blocks, blocks_swa, s) -> {path key: tensor}: the pages
    at ``blocks`` of every full-attention pool leaf and at ``blocks_swa``
    of every sliding-window one, and slot ``s``'s row of every per-slot
    leaf.  Every result is a copy (indexing by an id tensor, or a clone),
    never a view of the live caches.  Ids outside a pool are clamped into
    it, as the JAX version does; the caller slices such rows away."""
    check_ported(cfg)

    def gather_blocks(caches, blocks, blocks_swa, s):
        out = {}
        for top, idx, name, axis, leaf in _cache_leaves(caches):
            pre = (slice(None),) * axis
            if name in POOL_LEAVES:
                ids = (blocks_swa if _pool_mixer(cfg, top, idx) == SWA
                       else blocks)
                ids = torch.as_tensor(ids, dtype=torch.long,
                                      device=leaf.device)
                ids = ids.clamp(0, leaf.shape[axis] - 1)
                out[_path_key(top, idx, name)] = leaf[pre + (ids,)]
            else:
                out[_path_key(top, idx, name)] = leaf[pre + (s,)].clone()
        return out
    return gather_blocks


def make_scatter_blocks(cfg: ModelConfig):
    """Inverse of ``make_gather_blocks``, in place: payload row j of a
    pool leaf lands on page ``blocks[j]`` (``blocks_swa[j]`` for
    sliding-window pools), and each per-slot leaf's payload on slot
    ``s``.  Rows whose id lies outside the pool are dropped — filtered,
    as the JAX version's scatter drops them — which is how deduplicated
    pages (already resident) keep their payload rows from landing."""
    check_ported(cfg)

    def scatter_blocks(caches, payload, blocks, blocks_swa, s):
        for top, idx, name, axis, leaf in _cache_leaves(caches):
            pre = (slice(None),) * axis
            pay = payload[_path_key(top, idx, name)]
            if name in POOL_LEAVES:
                ids = (blocks_swa if _pool_mixer(cfg, top, idx) == SWA
                       else blocks)
                rows = [j for j, b in enumerate(ids)
                        if 0 <= b < leaf.shape[axis]]
                if rows:
                    dst = torch.as_tensor([ids[j] for j in rows],
                                          dtype=torch.long,
                                          device=leaf.device)
                    src = torch.as_tensor(rows, dtype=torch.long,
                                          device=leaf.device)
                    leaf[pre + (dst,)] = pay[pre + (src,)].to(leaf.dtype)
            else:
                leaf[pre + (s,)] = pay.to(leaf.dtype)
        return caches
    return scatter_blocks


class ServingEngine:
    """Fixed-slot continuous batching with chunked prefill and an optional
    paged slot cache, as ``repro.serve.engine.ServingEngine``.

    Admission runs a prompt through the shared slot cache in
    ``ceil(S / chunk)`` batched steps (other slots masked with position
    -1); each ``tick`` decodes one token for every active slot in one
    step.  ``paged=True`` keeps K/V in per-layer pools of ``num_blocks``
    pages addressed through a host ``(slots, ceil(cache_len / page))``
    block table: a request reserves ``ceil((prompt + max_new) / page)``
    pages at admission, takes them as it writes, and frees them when it
    finishes (freed pages are scrubbed); a pool that cannot cover a
    reservation backpressures the FIFO queue.  Sliding-window layers draw
    ring pages from a pool of their own, ``slots * ceil(window / page)``
    pages (an exact fit, which never backpressures) with its own table;
    the step then takes the tables as {"attn", "swa"}.
    ``share_prefix=True`` attaches resident prompt-prefix pages by
    refcount (their prefill is skipped) and copies a shared page before
    the first write into it; ``hold_pages`` > 0 keeps up to that many
    refcount-zero registered pages in an LRU hold so a readmitted prefix
    still finds them.  ``use_kernel=True`` (paged only) runs each mixer's
    Hopper kernel where the port has one: decode attention through the
    paged-decode kernel, the Mamba and RWKV recurrences (prefill and
    decode) through ``mamba_scan`` / ``rwkv_scan``.  Each computes what
    the plain path computes.  Recurrent layers keep their state per slot;
    models with them, with sliding-window rings (overwritten in place) or
    with MoE FFNs share no prefix.  Full-attention layers bound the
    context by ``cache_len``; models without them (rings wrap, recurrent
    state has no length) admit longer prompts.

    Stateful failover (paged engines): ``export_state`` lifts a live
    request's tokens, its pages of every pool kind, its per-slot state
    and a chained crc32 over all of it off the card and releases its
    slot; ``import_state`` verifies the checksum first (a corrupted
    payload is rejected with the pools untouched), attaches resident
    prefix pages by reference and writes the rest, and the request
    decodes on as if it had never moved.  A request with
    ``resume_tokens`` prefills prompt + resume as one prompt.
    ``drain_requests`` / ``preempt_newest`` / ``set_pool_pressure`` and
    the accessors below serve ``serve.router.FleetRouter``.

    The engine runs on ``device`` (cuda unless "cpu" is asked for); the
    parameters must already live there."""

    def __init__(self, params: dict, cfg: ModelConfig, *, slots: int = 4,
                 cache_len: int = 512, chunk: int = 32, paged: bool = False,
                 page_size: int = 16, num_blocks: Optional[int] = None,
                 use_kernel: bool = False, share_prefix: bool = True,
                 hold_pages: int = 0, seed: int = 0,
                 device: DeviceLike = None):
        check_ported(cfg)
        if use_kernel and not paged:
            raise ValueError(
                "ServingEngine: use_kernel=True requires paged=True — the "
                "paged-decode kernel reads the block-table pool (dense "
                "engines keep the plain paths)")
        self.device = resolve_device(device)
        pdev = device_of(params)
        if pdev is not None and pdev.type != self.device.type:
            raise ValueError(f"ServingEngine: params live on {pdev}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.chunk = max(1, min(chunk, cache_len))
        self.paged = paged
        self.page_size = page_size
        self.use_kernel = use_kernel
        # only full-attention caches bound the context; prefix sharing
        # holds only where skipping a page's prefill leaves no other state
        # stale and changes no result: a recurrent carry would still need
        # the skipped tokens, a ring page is overwritten in place, and MoE
        # capacity truncation depends on the chunk's shape
        specs = tuple(cfg.prefix_layers) + tuple(cfg.period)
        self._has_attn = any(sp.mixer == ATTN for sp in specs)
        self._has_swa = any(sp.mixer == SWA for sp in specs)
        self._has_recurrent = any(sp.mixer in (MAMBA, RWKV) for sp in specs)
        self._bounded_ctx = self._has_attn
        self._can_share = (paged and share_prefix and self._has_attn
                           and not self._has_swa and not self._has_recurrent
                           and not cfg.n_experts)
        if paged:
            self.n_cols = max(1, -(-cache_len // page_size))
            self.num_blocks = (num_blocks if num_blocks is not None
                               else max(1, -(-slots * cache_len // page_size)))
            self._alloc = BlockAllocator(
                self.num_blocks,
                hold_limit=hold_pages if self._can_share else 0)
            self._table = np.full((slots, self.n_cols), -1, np.int32)
            self._slot_reserved = [0] * slots
            self._ring_blocks = (swa_ring_blocks(cfg.sliding_window,
                                                 page_size, self.n_cols)
                                 if self._has_swa else 0)
            self.num_blocks_swa = slots * self._ring_blocks
            if self._has_swa:
                self._alloc_swa = BlockAllocator(self.num_blocks_swa)
                self._table_swa = np.full((slots, self._ring_blocks), -1,
                                          np.int32)
                self._slot_reserved_swa = [0] * slots
            self.caches = init_cache(cfg, slots, cache_len, paged=True,
                                     page_size=page_size,
                                     num_blocks=self.num_blocks,
                                     num_blocks_swa=self.num_blocks_swa,
                                     device=self.device)
        else:
            self.num_blocks = 0
            self.num_blocks_swa = 0
            self._ring_blocks = 0
            self._table = np.zeros((slots, 1), np.int32)   # dummy, unread
            self.caches = init_cache(cfg, slots, cache_len,
                                     device=self.device)
        self._step_fn = make_engine_step(cfg, paged=paged,
                                         use_kernel=use_kernel)
        self._clear_blocks_fn = make_clear_blocks(cfg)
        self._gather_blocks_fn = make_gather_blocks(cfg)
        self._scatter_blocks_fn = make_scatter_blocks(cfg)
        self._seen = torch.zeros((slots, cfg.vocab_size), dtype=torch.bool,
                                 device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.positions = [0] * slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        # table columns of slot s currently mapped to a SHARED page
        self._slot_shared: List[set] = [set() for _ in range(slots)]
        self.stats = {"prefill_calls": 0, "decode_calls": 0, "admitted": 0,
                      "backpressure": 0, "shared_pages": 0,
                      "shared_tokens": 0, "cow_copies": 0, "preempted": 0,
                      "exported": 0, "imported": 0, "import_rejects": 0,
                      "imported_pages": 0, "deduped_pages": 0,
                      "resumed_tokens": 0}
        self._seed = seed
        self._step_seq = 0
        self._admit_seq = 0
        self._admitted_at = [0] * slots
        self._temp = np.zeros((slots,), np.float32)
        self._topp = np.ones((slots,), np.float32)
        self._topk = np.zeros((slots,), np.int32)
        self._reppen = np.ones((slots,), np.float32)

    # -- paged-pool bookkeeping (host side) -----------------------------

    def _blocks_for(self, logical_len: int) -> int:
        """Full-attention pool pages a request of total logical length
        ``logical_len`` can ever touch (bounded by the table width); zero
        without full-attention layers (rings have their own exact-fit
        pool, recurrent state is per slot)."""
        if not self.paged or not self._has_attn:
            return 0
        return min(-(-logical_len // self.page_size), self.n_cols)

    def _reserve_swa(self, s: int, logical_len: int) -> None:
        """Reserve slot ``s``'s ring pages (bounded by the ring); the
        exact-fit ring pool cannot run short."""
        if not self.paged or not self._has_swa:
            return
        need = min(-(-logical_len // self.page_size), self._ring_blocks)
        if not self._alloc_swa.reserve(need):
            raise RuntimeError("ServingEngine: the exact-fit ring pool is "
                               "short")
        self._slot_reserved_swa[s] = need

    # -- content-addressed prefix pages ---------------------------------

    @staticmethod
    def _digest(payload) -> int:
        """Digest of one prefix page: the payload chains the parent page's
        digest with this page's tokens."""
        return hash(payload)

    def prefix_digests(self, prompt: List[int]) -> List[int]:
        """Chain digests of every FULL page of ``prompt``."""
        P = self.page_size
        out: List[int] = []
        prev = 0
        for i in range(len(prompt) // P):
            prev = self._digest((prev, tuple(prompt[i * P:(i + 1) * P])))
            out.append(prev)
        return out

    def _match_prefix(self, prompt: List[int]):
        """Longest resident shared prefix of ``prompt``: (shared_tokens,
        full_hits [(col, block)], partial_hit (col, block, covered) or
        None) — a registered PARTIAL page may extend the match past the
        last full hit."""
        P = self.page_size
        S = len(prompt)
        hits: List[Tuple[int, int]] = []
        prev_d, prev_b = 0, -1
        m = 0
        for i in range(S // P):
            page = tuple(prompt[i * P:(i + 1) * P])
            d = self._digest((prev_d, page))
            b = self._alloc.lookup(d, (prev_b, page))
            if b is None:
                break
            hits.append((i, b))
            prev_d, prev_b = d, b
            m += 1
        partial = None
        best = 0
        for j in range(m * P + 1, min(S, (m + 1) * P) + 1):
            tail = tuple(prompt[m * P:j])
            d = self._digest((prev_d, tail, "partial"))
            b = self._alloc.lookup(d, (prev_b, tail, "partial"))
            if b is not None and j > best:
                partial, best = (m, b, j), j
        return (best if partial else m * P), hits, partial

    def shared_prefix_pages(self, prompt: List[int]) -> int:
        """Prefix pages of ``prompt`` resident now (full hits and a
        trailing partial one): the router's affinity signal."""
        if not self._can_share:
            return 0
        _, hits, partial = self._match_prefix(prompt)
        return len(hits) + (1 if partial else 0)

    def prefill_calls_for(self, prompt: List[int]) -> int:
        """Chunked-prefill calls admitting ``prompt`` would cost now
        (resident shared pages skipped; at least the last token runs)."""
        S = len(prompt)
        if self._can_share:
            shared, _, _ = self._match_prefix(prompt)
            S -= min(shared, S - 1)
        return -(-S // self.chunk)

    def _register_prefix(self, s: int, prompt: List[int],
                         include_partial: bool = True) -> None:
        """Advertise slot ``s``'s freshly admitted prompt pages: every
        FULL page under its chain digest, plus the trailing partial page
        unless ``include_partial`` is False (an imported slot's last
        prompt page already holds decoded tokens)."""
        P = self.page_size
        S = len(prompt)
        prev_d, prev_b = 0, -1
        for i in range(S // P):
            page = tuple(prompt[i * P:(i + 1) * P])
            d = self._digest((prev_d, page))
            b = int(self._table[s, i])
            self._alloc.register(d, (prev_b, page), b)
            canon = self._alloc.lookup(d, (prev_b, page))
            prev_d, prev_b = d, (canon if canon is not None else b)
        if S % P and include_partial:
            tail = tuple(prompt[(S // P) * P:])
            d = self._digest((prev_d, tail, "partial"))
            self._alloc.register(d, (prev_b, tail, "partial"),
                                 int(self._table[s, S // P]))

    def _cow(self, s: int, c: int) -> None:
        """Copy-on-write table column ``c`` of slot ``s``: a private page
        against the slot's reservation, the shared page's contents copied
        on the device, the table repointed, the shared reference dropped."""
        old = int(self._table[s, c])
        new = self._alloc.alloc_one()
        self._slot_reserved[s] -= 1
        _copy_block(self.caches, old, new)
        self._table[s, c] = new
        freed = self._alloc.free([old])
        if freed:
            raise RuntimeError("ServingEngine: CoW of an unshared page")
        self._slot_shared[s].discard(c)
        self.stats["cow_copies"] += 1

    def _ensure_blocks(self, s: int, p_lo: int, p_hi: int) -> None:
        """Make the table columns that writes at positions [p_lo, p_hi]
        touch writable: allocate unmapped columns, copy shared pages
        first, and deregister an owned page whose content will change;
        map the ring columns those positions wrap onto."""
        if not self.paged:
            return
        P = self.page_size
        if self._has_attn:
            for c in range(p_lo // P, p_hi // P + 1):
                b = int(self._table[s, c])
                if b < 0:
                    self._table[s, c] = self._alloc.alloc_one()
                    self._slot_reserved[s] -= 1
                elif self._can_share:
                    if self._alloc.refcount.get(b, 0) > 1:
                        self._cow(s, c)
                    else:
                        self._alloc.deregister(b)
                        self._slot_shared[s].discard(c)
        if self._has_swa:
            ring_p = self._ring_blocks * P
            if p_hi - p_lo + 1 >= ring_p:
                cols = range(self._ring_blocks)
            else:
                c0, c1 = (p_lo % ring_p) // P, (p_hi % ring_p) // P
                cols = (range(c0, c1 + 1) if c0 <= c1 else
                        list(range(c0, self._ring_blocks))
                        + list(range(c1 + 1)))
            for c in cols:
                if self._table_swa[s, c] < 0:
                    self._table_swa[s, c] = self._alloc_swa.alloc_one()
                    self._slot_reserved_swa[s] -= 1

    def _free_slot_blocks(self, s: int) -> None:
        """Drop a finished slot's page references and unused reservations
        of both pool kinds; only pages whose refcount reached zero (and
        pages the LRU hold evicted) are scrubbed."""
        if not self.paged:
            return
        blocks = [int(b) for b in self._table[s] if b >= 0]
        scrub: List[int] = []
        if blocks or self._slot_reserved[s]:
            scrub = self._alloc.free(blocks, unreserve=self._slot_reserved[s])
            self._slot_reserved[s] = 0
        scrub_swa: List[int] = []
        if self._has_swa:
            sblocks = [int(b) for b in self._table_swa[s] if b >= 0]
            if sblocks or self._slot_reserved_swa[s]:
                scrub_swa = self._alloc_swa.free(
                    sblocks, unreserve=self._slot_reserved_swa[s])
                self._slot_reserved_swa[s] = 0
            self._table_swa[s] = -1
        self._scrub_blocks(scrub + self._alloc.take_scrub(), scrub_swa)
        self._table[s] = -1
        self._slot_shared[s].clear()

    def _scrub_blocks(self, scrub: List[int],
                      scrub_swa: List[int] = ()) -> None:
        """Zero recycled pool pages (keys 0, positions -1), each list in
        the pools of its kind."""
        if len(scrub) or len(scrub_swa):
            self.caches = self._clear_blocks_fn(self.caches, scrub, scrub_swa)

    def _drain_scrub(self) -> None:
        """Scrub pages the LRU hold evicted (free-listed, stale)."""
        if self.paged:
            self._scrub_blocks(self._alloc.take_scrub())

    def _release_slot(self, s: int) -> None:
        """Vacate slot ``s`` (finish, drain, preemption, export): free +
        scrub its pages and restore the greedy sampling defaults (so an
        idle slot keeps the fast paths on)."""
        self.active[s] = None
        self._free_slot_blocks(s)
        self._temp[s] = 0.0
        self._topp[s] = 1.0
        self._topk[s] = 0
        self._reppen[s] = 1.0

    def _table_arg(self):
        """The block-table operand: one tensor, or per-kind tables {"attn",
        "swa"} where the pools have split block-id spaces."""
        if self.paged and self._has_swa:
            return {"attn": torch.from_numpy(self._table).to(self.device),
                    "swa": torch.from_numpy(self._table_swa).to(self.device)}
        return torch.from_numpy(self._table).to(self.device)

    # -- occupancy / fleet hooks (read by serve.router.FleetRouter) ------

    @property
    def n_active(self) -> int:
        return sum(1 for r in self.active if r is not None)

    def admitted_requests(self) -> List[Request]:
        """Requests holding a slot, in admission order."""
        live = [s for s in range(self.slots) if self.active[s] is not None]
        live.sort(key=lambda s: self._admitted_at[s])
        return [self.active[s] for s in live]

    @property
    def pending_tokens(self) -> int:
        """Tokens still ahead of this engine: queued requests' prompt +
        max_new, admitted requests' remaining decode."""
        tok = sum(len(r.prompt) + r.max_new for r in self.queue)
        tok += sum(r.max_new - len(r.generated)
                   for r in self.active if r is not None)
        return tok

    @property
    def pending_prefill_calls(self) -> int:
        """Chunked-prefill calls still ahead of this engine's queue."""
        return sum(self.prefill_calls_for(r.prompt) for r in self.queue)

    @property
    def free_pages(self) -> int:
        """Full-attention pool pages not yet committed: free + held minus
        reservations, withheld pages and the worst case of the queue.
        Dense engines report a sentinel no page check binds on."""
        if not self.paged:
            return 1 << 30
        queued = sum(self._blocks_for(len(r.prompt) + r.max_new)
                     for r in self.queue)
        return (self._alloc.n_free + self._alloc.n_held
                - self._alloc.reserved - self._alloc.withheld - queued)

    @property
    def occupancy(self) -> dict:
        """A host-side snapshot of the engine's load (no device sync)."""
        return {
            "active": self.n_active,
            "queued": len(self.queue),
            "free_slots": self.slots - self.n_active,
            "pending_tokens": self.pending_tokens,
            "free_pages": self.free_pages if self.paged else None,
        }

    def can_serve(self, prompt: List[int], max_new: int) -> bool:
        """Could this engine ever run such a request?  ``submit``'s checks
        without raising, plus the vocabulary bound."""
        if not prompt or max(prompt) >= self.cfg.vocab_size:
            return False
        if self._bounded_ctx and len(prompt) + max_new > self.cache_len:
            return False
        if self.paged and self._blocks_for(len(prompt) + max_new) \
                > self.num_blocks:
            return False
        return True

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pool pages a request would reserve at admission."""
        return self._blocks_for(prompt_len + max_new)

    def _kind_page_bytes(self, swa: bool) -> int:
        total = 0
        for top, idx, name, axis, leaf in _cache_leaves(self.caches):
            if name in POOL_LEAVES and \
                    (_pool_mixer(self.cfg, top, idx) == SWA) == swa:
                total += (leaf.numel() * leaf.element_size()
                          // leaf.shape[axis])
        return total

    @property
    def page_bytes(self) -> int:
        """Bytes of one full-attention page across every paged leaf (the
        unit of the router's migration byte estimate)."""
        return self._kind_page_bytes(False) if self.paged else 0

    @property
    def page_bytes_swa(self) -> int:
        """Bytes of one sliding-window ring page across every ring leaf."""
        return self._kind_page_bytes(True) if self.paged else 0

    # -- stateful failover -----------------------------------------------

    def registry_digests(self) -> frozenset:
        """Digests in the content registry (held pages included): the
        view the router gossips on heartbeats."""
        if not self._can_share:
            return frozenset()
        return frozenset(self._alloc._by_digest)

    def migration_fingerprint(self) -> tuple:
        """Compatibility key of a migration: the same weights object, the
        same architecture and the same page geometry."""
        return (id(self.params), self.cfg, self.paged, self.page_size,
                self.cache_len)

    def export_state(self, req: Request) -> Optional[RequestState]:
        """Lift a live request's decode state off the card and release
        its slot: every pool page its tables map (by kind), its per-slot
        state, its prompt's digest trail and a chained crc32 over all of
        it.  None for dense engines or a request not admitted here."""
        if not self.paged:
            return None
        s = next((i for i in range(self.slots) if self.active[i] is req),
                 None)
        if s is None:
            return None
        cols = [c for c in range(self.n_cols) if self._table[s, c] >= 0]
        blocks = [int(self._table[s, c]) for c in cols]
        cols_swa, blocks_swa = [], []
        if self._has_swa:
            cols_swa = [c for c in range(self._ring_blocks)
                        if self._table_swa[s, c] >= 0]
            blocks_swa = [int(self._table_swa[s, c]) for c in cols_swa]
        payload = self._gather_blocks_fn(self.caches, blocks, blocks_swa, s)
        pool: Dict[str, np.ndarray] = {}
        slot_state: Dict[str, np.ndarray] = {}
        for key, t in payload.items():
            (pool if key.rsplit("/", 1)[1] in POOL_LEAVES
             else slot_state)[key] = _to_host(t)
        del payload
        state = RequestState(
            req=req, position=self.positions[s],
            fingerprint=self.migration_fingerprint(),
            cols=cols, cols_swa=cols_swa, pool=pool, slot_state=slot_state,
            digests=self.prefix_digests(req.prompt), checksum=0,
            payload_bytes=(sum(a.nbytes for a in pool.values())
                           + sum(a.nbytes for a in slot_state.values())))
        state.checksum = state_checksum(state)
        req.prefix_digests = state.digests
        self._release_slot(s)
        self.stats["exported"] += 1
        return state

    def import_state(self, state: RequestState) -> bool:
        """Attach a migrated request mid-decode.  The checksum chain is
        verified first: a mismatch rejects the whole transfer before a
        byte reaches a pool.  Resident prefix pages attach by reference,
        the rest land in fresh pages, and the slot's position, sampling
        parameters and seen mask are restored.  False, with the engine
        untouched, when no slot or pages are free, the fingerprint
        differs, or verification fails."""
        req = state.req
        if not self.paged \
                or state.fingerprint != self.migration_fingerprint():
            return False
        s = next((i for i in range(self.slots) if self.active[i] is None),
                 None)
        if s is None:
            return False
        if state_checksum(state) != state.checksum:
            self.stats["import_rejects"] += 1
            return False
        S = len(req.prompt)
        hits: List[Tuple[int, int]] = []
        if self._can_share:
            _, hits, _ = self._match_prefix(req.prompt)
        resident = {c: b for (c, b) in hits if c in set(state.cols)}
        need = self._blocks_for(S + req.max_new) - len(resident)
        if not self._alloc.reserve(need):
            return False
        self._slot_reserved[s] = need
        self._reserve_swa(s, S + req.max_new)
        self._drain_scrub()
        _clear_slot(self.caches, s, skip_pools=True)
        self._seen[s] = False
        # deduped columns keep an out-of-pool id: the scatter drops
        # their payload rows
        ids = [self.num_blocks] * len(state.cols)
        written = 0
        for j, c in enumerate(state.cols):
            if c in resident:
                b = resident[c]
                self._alloc.share(b)
                self._table[s, c] = b
                self._slot_shared[s].add(c)
            else:
                b = self._alloc.alloc_one()
                self._slot_reserved[s] -= 1
                self._table[s, c] = b
                ids[j] = b
                written += 1
        ids_swa = []
        for c in state.cols_swa:
            b = self._alloc_swa.alloc_one()
            self._slot_reserved_swa[s] -= 1
            self._table_swa[s, c] = b
            ids_swa.append(b)
        payload = {}
        for top, idx, name, _, leaf in _cache_leaves(self.caches):
            key = _path_key(top, idx, name)
            src = (state.pool if name in POOL_LEAVES
                   else state.slot_state)[key]
            payload[key] = _to_device(src, leaf)
        self.caches = self._scatter_blocks_fn(self.caches, payload, ids,
                                              ids_swa, s)
        self.active[s] = req
        self._admit_seq += 1
        self._admitted_at[s] = self._admit_seq
        self.positions[s] = state.position
        self._temp[s] = req.temperature
        self._topp[s] = req.top_p
        self._topk[s] = req.top_k
        self._reppen[s] = req.rep_penalty
        if req.rep_penalty != 1.0:
            # the seen mask is kept from step inputs this engine never
            # saw: rebuild it from prompt + generated
            idx = torch.as_tensor(req.prompt + req.generated,
                                  dtype=torch.long, device=self.device)
            self._seen[s, idx] = True
        if self._can_share:
            self._register_prefix(s, req.prompt, include_partial=False)
        self.stats["imported"] += 1
        self.stats["imported_pages"] += written + len(state.cols_swa)
        self.stats["deduped_pages"] += len(resident)
        return True

    @staticmethod
    def _reset_request(req: Request) -> None:
        req.generated = []
        req.pending = -1
        req.done = False

    def drain_requests(self) -> List[Request]:
        """Harvest every live request — admitted slots in admission order,
        then the queue — reset to re-prefill from its prompt (its digest
        trail stamped), leaving the engine empty."""
        out: List[Request] = []
        live = [s for s in range(self.slots) if self.active[s] is not None]
        for s in sorted(live, key=lambda s: self._admitted_at[s]):
            out.append(self.active[s])
            self._release_slot(s)
        out.extend(self.queue)
        self.queue = []
        for req in out:
            self._reset_request(req)
            req.prefix_digests = self.prefix_digests(req.prompt)
        return out

    def preempt_newest(self) -> Optional[Request]:
        """Evict the youngest live request — the queue's tail, else the
        latest admitted slot — reset as ``drain_requests`` resets it.
        None when the engine is idle."""
        if self.queue:
            req = self.queue.pop()
        else:
            live = [s for s in range(self.slots) if self.active[s] is not None]
            if not live:
                return None
            s = max(live, key=lambda s: self._admitted_at[s])
            req = self.active[s]
            self._release_slot(s)
        self._reset_request(req)
        req.prefix_digests = self.prefix_digests(req.prompt)
        self.stats["preempted"] += 1
        return req

    def set_pool_pressure(self, pages: int) -> None:
        """Withhold ``pages`` full-attention pool pages from new
        admissions (held pages go first); 0 restores the pool.  Admitted
        requests' reservations are untouched, and the exact-fit ring pool
        is never squeezed."""
        if not self.paged or not self._has_attn:
            return
        pages = max(0, int(pages))
        if pages:
            self._alloc.evict_held(pages)
            self._drain_scrub()
        self._alloc.withheld = pages

    # -- request intake --------------------------------------------------

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(
                f"ServingEngine: request {req.req_id} has an empty prompt — "
                f"at least one prompt token is required to seed decoding")
        if self._bounded_ctx and len(req.prompt) + req.max_new > self.cache_len:
            # only full-attention caches bound the context: rings wrap
            # under the window mask, recurrent state has no length
            raise ValueError(
                f"ServingEngine: request {req.req_id} needs "
                f"{len(req.prompt)} prompt + {req.max_new} new tokens but "
                f"cache_len={self.cache_len}; full-attention caches must "
                f"not wrap (raise cache_len or lower max_new)")
        if self.paged:
            need = self._blocks_for(len(req.prompt) + req.max_new)
            if need > self.num_blocks:
                raise ValueError(
                    f"ServingEngine: request {req.req_id} needs {need} cache "
                    f"pages but the pool has only {self.num_blocks} — it "
                    f"could never be admitted (raise num_blocks)")
        self.queue.append(req)

    def warmup(self) -> None:
        """Run the two engine shapes — the chunked-prefill step (slots,
        chunk) and the decode tick (slots, 1) — with every position
        masked (-1, a cache no-op) so one-time set-up (kernel build, BLAS
        handles) happens ahead of traffic without touching engine state."""
        for C in sorted({self.chunk, 1}):
            toks = np.zeros((self.slots, C), np.int32)
            pos = np.full((self.slots, C), -1, np.int32)
            self._call_step(toks, pos)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the serving loop ------------------------------------------------

    def _call_step(self, toks: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One engine step; host operands move to the device once here.
        The per-slot sampling keys are counters (slot seed, step)."""
        keys = np.empty((self.slots, 2), np.uint32)
        keys[:, 0] = np.arange(self._seed, self._seed + self.slots,
                               dtype=np.uint32)
        keys[:, 1] = np.uint32(self._step_seq)
        self._step_seq += 1
        nxt, self.caches, self._seen = self._step_fn(
            self.params, self.caches, self._seen,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device), self._table_arg(), keys,
            self._temp, self._topp, self._topk, self._reppen)
        return nxt

    def _admit(self) -> None:
        """Chunked-prefill admission of queued requests into free slots:
        reserve the request's worst-case pages of each kind (a short
        full-attention pool stops the FIFO queue: backpressure), attach
        its resident shared prefix pages, then walk the rest of the
        prompt — and its ``resume_tokens`` — through the cache ``chunk``
        tokens per step.  At least the last token always runs (its
        logits seed decoding)."""
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue[0]
                # snapshot restore: prompt + resume tokens prefill as ONE
                # prompt; the budget stays prompt + max_new
                resume = list(req.resume_tokens or ())
                full = req.prompt + resume
                S = len(full)
                total = S + req.max_new - len(resume)
                shared_tok, hits, partial = (
                    self._match_prefix(full) if self._can_share
                    else (0, [], None))
                start = min(shared_tok, S - 1)
                if self.paged:
                    # reserve only unshared pages — but a shared page the
                    # tail writes into still needs a page for its CoW
                    untouched = sum(1 for (i, _) in hits
                                    if (i + 1) * self.page_size <= start)
                    need = self._blocks_for(total) - untouched
                    if not self._alloc.reserve(need):
                        self.stats["backpressure"] += 1
                        break          # FIFO: later requests wait too
                    self._slot_reserved[s] = need
                    self._drain_scrub()
                    self._reserve_swa(s, total)
                self.queue.pop(0)
                self.active[s] = req
                self._admit_seq += 1
                self._admitted_at[s] = self._admit_seq
                _clear_slot(self.caches, s, skip_pools=self.paged)
                self._seen[s] = False
                self._temp[s] = req.temperature
                self._topp[s] = req.top_p
                self._topk[s] = req.top_k
                self._reppen[s] = req.rep_penalty
                attached = hits + ([partial[:2]] if partial else [])
                for (c, b) in attached:
                    self._table[s, c] = b
                    self._alloc.share(b)
                    self._slot_shared[s].add(c)
                self.stats["shared_pages"] += len(attached)
                self.stats["shared_tokens"] += start
                prompt = np.asarray(full, np.int32)
                nxt = None
                for c0 in range(start, S, self.chunk):
                    piece = prompt[c0:c0 + self.chunk]
                    C = len(piece)
                    self._ensure_blocks(s, c0, c0 + C - 1)
                    toks = np.zeros((self.slots, C), np.int32)
                    toks[s] = piece
                    pos = np.full((self.slots, C), -1, np.int32)
                    pos[s] = np.arange(c0, c0 + C, dtype=np.int32)
                    nxt = self._call_step(toks, pos)
                    self.stats["prefill_calls"] += 1
                if self._can_share:
                    self._register_prefix(s, full)
                self.positions[s] = S
                req.pending = int(nxt[s, 0])
                if resume:
                    req.generated = resume
                    req.resume_tokens = None
                    self.stats["resumed_tokens"] += len(resume)
                self.stats["admitted"] += 1

    def tick(self) -> int:
        """One engine iteration: admit, then feed each active slot's
        pending token and compute the next for all slots in one step.
        Returns the number of active slots."""
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        pos = np.full((self.slots, 1), -1, np.int32)
        for s in act:
            self._ensure_blocks(s, self.positions[s], self.positions[s])
            toks[s, 0] = self.active[s].pending
            pos[s, 0] = self.positions[s]
        nxt = self._call_step(toks, pos).cpu().numpy()   # one copy, all slots
        self.stats["decode_calls"] += 1
        for s in act:
            req = self.active[s]
            req.generated.append(req.pending)
            req.pending = int(nxt[s, 0])
            self.positions[s] += 1
            if len(req.generated) >= req.max_new:
                req.done = True
                self.finished.append(req)
                self._release_slot(s)
        return len(act)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.tick() and not self.queue:
                break
        return self.finished
