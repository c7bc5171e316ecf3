"""Model facade of every family: build_model(cfg) -> init / loss_fn /
prefill / decode_step.

The port of ``repro/models/model.py``: ``family == "dense"``, ``"moe"``
(mixtral-8x22b, and deepseek-v2-236b with MLA), ``"encdec"``
(whisper-medium), ``"vlm"`` (internvl2-76b), ``"xlstm"`` (xlstm-350m) and
``"hybrid"`` (zamba2-2.7b).  Batch formats as in the reference:
  train   : {"tokens": (B, S) int, "labels": (B, S) int}
            (+ "frames" (B, Se, D) for encdec, "patches" (B, P, D) for vlm)
  prefill : {"tokens": (B, S) int, "cache_seq": int (default S)}
            (+ "frames" for encdec)
  decode  : {"token": (B, 1) int, "pos": int,
             "cache": {"k", "v"[, "kpos"]} or MLA's {"c_kv", "k_rope"},
             or encdec's {"self": {"k", "v"}, "cross": (k, v)}, or the
             recurrent families' states (``transformer.init_xlstm_states``,
             ``init_hybrid_states``)}
``pos`` is a Python int here (the reference's is a traced scalar), so
that a decode step needs no read from the device.  Caches are updated in
place and returned; ``init_cache(..., ring=True)`` gives the SWA ring
buffer.  The encoder-decoder runs a stub front end, as the reference does:
``frames`` are precomputed frame embeddings (B, encoder_seq, d_model).
Its encoder adds sinusoidal positions and runs a bidirectional stack; its
decoder adds sinusoidal positions to the token embeddings; prefill
projects the encoder's output to every decoder layer's cross (k, v), the
cache's ``cross``, which decode reads.
Under tensor parallelism (``shardctx.tensor_parallel()``: the serving
steps over a mesh, ``launch.steps``) a place holds the vocab rows
``embed`` and the vocab columns of ``lm_head`` (or of the tied
``embed.T``) of its coordinate on the model axis: the lookup puts each
token's row on the place that holds it and zero elsewhere, then sums the
places in rank order (exact: one term is not zero); the logits of its
columns are gathered in rank order to the whole padded vocab, so that
``argmax`` is the reference's (ties to the lowest index).  A cache or
state is the place's block of ``launch.sharding.cache_specs``' cut
(``init_cache``): its rows, kv heads or head_dim slice, MLA's r and dr
slices, the mLSTM value dim, Mamba2's heads and conv channels; the
mLSTM ``m`` state holds every row of the global batch (``_m_rows``).
The loss over a mesh reads the place's vocab columns of the logits
(``_nll_vocab_cut``: the row's log-sum-exp and the label's logit added
over the model axis in rank order), and is the global batch's: the sum
of nll and the label count of the place's rows, each added over the
batch axes in rank order (whose backward is the identity: each place's gradient is its
rows', summed over the batch axes by ``launch.steps``).  Where autograd
records, a whole tensor that meets the place's block (the head's input,
the encoder's output into the cross-attention's kv blocks, a whole bias
cut to a head_dim slice) is ``tp.enter``-ed (``launch.mesh``); the
vocab block's lookup keeps ``_EmbeddingLookup``'s ordered backward.
With the data axis's cut of the dense weights (``shardctx.fsdp()``:
FSDP over a mesh) ``embed`` is the place's block of d_model too and
``lm_head`` of its rows: the lookup moves the tokens' rows, never the
table (``launch.mesh.lookup_cut``), and the head gathers its weight whole
over data in the compute dtype (``launch.mesh.gather_weight``), once a
call, a tied ``embed`` included; the layers gather theirs
(``transformer``).
The VLM is the dense stack; its loss puts the stub front end's
``patches`` ahead of the token embeddings (positions 0..P+S-1, the patch
positions unlabelled).  Its prefill and decode read no patches: the
reference's never do (its module docstring says they are folded into the
cache at prefill time; its code does not), and the port computes what the
code computes.  The recurrent families (xlstm, hybrid) have no prefill:
``prefill`` raises, as the reference's does, and the serving loop warms
their states by stepping ``decode_step`` over the prompt.

Parameters are a dict: ``embed`` (V, D), ``final_norm``, ``lm_head`` (D, V)
unless the embeddings are tied, and ``stack``, a list of per-layer dicts
(``transformer.init_layer``; an MoE layer holds ``moe`` in place of
``mlp``; an MLA layer's ``attn`` holds ``layers.init_mla``'s leaves; an
encoder-decoder's decoder layer adds ``ln_x`` and ``xattn``); the
encoder-decoder adds ``enc`` (a list of ``encoder_layers`` dicts) and
``enc_norm``; the recurrent families' ``stack`` is a dict of lists
(``transformer``'s docstring).
Vectors, the MoE router and the recurrent cells' gate projections live in
float32; matrices in the compute dtype for serving, or as float32 masters
cast at every product for training (``init(master=True)``), as the
reference keeps them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ModelConfig
from ..tree import tree_map_with_path
from . import layers as LL
from . import transformer as TR
from .shardctx import (
    axis_size,
    bf16_grad_barrier,
    current_rules,
    fsdp,
    tensor_parallel,
)

__all__ = ["Model", "build_model", "compute_dtype", "SHAPES",
           "shape_applicable", "input_specs"]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class _EmbeddingLookup(torch.autograd.Function):
    """``table[tokens]`` whose backward sums each token's rows in a fixed
    order: a stable sort of the positions by token, then one ordered
    segment sum a table row (``torch.segment_reduce``).  The default
    backward of an index accumulates with ``index_put_``, whose order on
    the card is the library's to choose; a bitwise resume needs two runs
    to give the same bits."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1).long()
        order = torch.argsort(flat, stable=True)
        lengths = torch.bincount(flat, minlength=ctx.rows)
        rows = g.reshape(flat.numel(), -1)[order]
        return torch.segment_reduce(rows, "sum", lengths=lengths,
                                    axis=0), None


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device = torch.device("cuda")

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, *, master: bool = False,
             keep=None) -> dict:
        """Random weights with the reference's scales, drawn on the device
        from ``torch.Generator(device).manual_seed(seed)`` one tensor at a
        time, in the compute dtype (serving: a float32 copy of a
        14.8 B-parameter model would be 59 GB), or as float32 masters with
        ``master=True`` (training).  Other numbers than ``jax.random`` for
        the same seed: to carry the reference's weights across, use
        ``convert.model_params_from_numpy``.  ``keep(path, tensor)`` (a
        ``tree`` path, list indices included; ``launch.sharding.
        keep_blocks``) takes each tensor right after its draw and returns
        what the tree holds of it (a rank's block), so the whole tensor
        is freed before the next draw: the peak is the blocks and one
        whole leaf.  The generator makes the same calls in the same
        order with or without ``keep``: each block is the one ``keep``
        cuts from the whole tree."""
        cfg, dev = self.cfg, torch.device(self.device)
        dt = torch.float32 if master else compute_dtype(cfg)
        # on the meta device (shapes only: launch.sharding's specs of a
        # full-size model) nothing is drawn
        gen = (None if dev.type == "meta" else
               torch.Generator(device=dev).manual_seed(seed))
        D, V = cfg.d_model, cfg.padded_vocab
        drawn = set()

        def keep_drawn(path, t):
            drawn.add(tuple(path))
            return keep(path, t)

        k = None if keep is None else keep_drawn
        params = {
            "embed": LL.kept(k, "embed", torch.randn(
                (V, D), generator=gen, dtype=dt, device=dev).mul_(0.02)),
            "final_norm": LL.init_norm(cfg, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = LL.kept(k, "lm_head", torch.randn(
                (D, V), generator=gen, dtype=dt, device=dev).mul_(
                    0.02 / math.sqrt(D)))
        fam = cfg.family
        if fam == "encdec":
            params["enc"] = TR.init_dense_stack(
                gen, cfg, dt, dev, n_layers=cfg.encoder_layers,
                keep=LL.sub_keep(k, "enc"))
            params["enc_norm"] = LL.init_norm(cfg, dev)
        stack = LL.sub_keep(k, "stack")
        if fam == "xlstm":
            params["stack"] = TR.init_xlstm_stack(gen, cfg, dt, dev,
                                                  keep=stack)
        elif fam == "hybrid":
            params["stack"] = TR.init_hybrid_stack(gen, cfg, dt, dev,
                                                   keep=stack)
        else:
            params["stack"] = TR.init_dense_stack(gen, cfg, dt, dev,
                                                  cross=fam == "encdec",
                                                  keep=stack)
        if keep is None:
            return params
        # the leaves init fills with one value (norms, biases), kept last
        return tree_map_with_path(
            lambda path, t: t if tuple(path) in drawn else keep(path, t),
            params)

    @staticmethod
    def param_count(params) -> int:
        def count(p):
            if isinstance(p, torch.Tensor):
                return p.numel()
            vals = p.values() if isinstance(p, dict) else p
            return sum(count(x) for x in vals)
        return count(params)

    # ------------------------------------------------------------- helpers
    def _embed(self, params, tokens):
        table = params["embed"]
        tp = tensor_parallel()
        if tp is not None and tp.layout.get("embed"):
            # the place's vocab rows: its tokens' rows, zero elsewhere,
            # summed over the model axis in rank order
            rows = table.shape[0]
            local = tokens - tp.rank * rows
            mine = (local >= 0) & (local < rows)
            x = self._lookup(table, local.clamp(0, rows - 1))
            x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
            return tp.sum(x).to(compute_dtype(self.cfg))
        return self._lookup(table, tokens).to(compute_dtype(self.cfg))

    def _lookup(self, table, tokens):
        """``table[tokens]``, through ``_EmbeddingLookup``'s ordered
        backward where autograd records the table; from the place's block
        of a table cut over data, in the compute dtype
        (``launch.mesh.lookup_cut``: the same bits, its backward ordered
        too)."""
        fs = fsdp()
        if fs is not None and fs.cuts("embed"):
            return fs.lookup(table, tokens, "embed", compute_dtype(self.cfg))
        if table.requires_grad and torch.is_grad_enabled():
            return _EmbeddingLookup.apply(table, tokens)
        return table[tokens]

    def _head(self, params):
        """The head's weight (D, V), the tied ``embed.T`` or ``lm_head``:
        under the data axis's cut gathered whole over data in the compute
        dtype (once a call: the lookup never gathers the table)."""
        key = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = params[key]
        fs = fsdp()
        if fs is not None and fs.cuts(key):
            w = fs.leaf(w, key)
        return w.T if self.cfg.tie_embeddings else w

    def _logits(self, params, x, gather: bool = True):
        """The head's logits of x; under tensor parallelism the place's
        vocab columns, gathered to the whole padded vocab in rank order
        unless ``gather=False``."""
        cfg = self.cfg
        x = LL.apply_norm(params["final_norm"], x, cfg.norm)
        x = bf16_grad_barrier(x)
        head = self._head(params)
        tp = tensor_parallel()
        cut = tp is not None and tp.layout.get("head")
        if cut:
            x = tp.enter(x)     # whole x into the place's vocab columns
        logits = x @ head.to(compute_dtype(cfg))
        if cut and gather:
            logits = tp.gather(logits, dim=logits.dim() - 1)
        return logits

    def _nll_vocab_cut(self, params, x, labels, tp):
        """Each token's -log softmax at its label from the place's vocab
        columns of the logits (float32), never gathering them whole: the
        row max over the places (exact, outside autograd), each place's
        sum of exp(logit - max) added over the places in rank order, and
        the label's logit from the place that holds it (one nonzero term
        in the ordered sum).  The same function as the whole row's
        ``logsumexp`` less the label's logit; a place holds (B, S, V/n)
        float32 where the whole row would take (B, S, V)."""
        local = self._logits(params, x, gather=False).float()
        v = local.shape[-1]
        peak = tp.gather(local.detach().amax(dim=-1)[None], 0).amax(dim=0)
        total = tp.sum(torch.exp(local - peak[..., None]).sum(dim=-1))
        logz = peak + torch.log(total)
        lab = labels.clamp(min=0).long() - tp.rank * v
        mine = (lab >= 0) & (lab < v)
        gold = local.gather(-1, lab.clamp(0, v - 1)[..., None])[..., 0]
        gold = tp.sum(torch.where(mine, gold, torch.zeros(
            (), dtype=gold.dtype, device=gold.device)))
        return logz - gold

    @staticmethod
    def _positions_added(x):
        """x (B, S, D) plus the sinusoidal rows 0..S-1 (the
        encoder-decoder's absolute positions), in x's dtype."""
        return x + LL.sinusoidal_on(x.shape[1], x.shape[2],
                                    x.device).to(x.dtype)

    def _encode(self, params, frames, flash: bool = False):
        """The encoder over precomputed frame embeddings (the stub front
        end): sinusoidal positions, a bidirectional stack, ``enc_norm``.
        ``flash=True`` routes its attention to the flash kernel,
        non-causal (one launch a layer on a CUDA tensor)."""
        cfg = self.cfg
        B, Se, _ = frames.shape
        x = self._positions_added(frames.to(compute_dtype(cfg)))
        pos = torch.arange(Se, dtype=torch.int32,
                           device=x.device).expand(B, Se)
        x, _, _ = TR.apply_dense_stack(params["enc"], x, cfg, pos,
                                       causal=False, flash=flash,
                                       prefix="enc")
        return LL.apply_norm(params["enc_norm"], x, cfg.norm)

    def _cross_kv(self, params, enc_out):
        """Every decoder layer's cross-attention (k, v) of the encoder's
        output, biases added: a pair of (L, B, Se, KV, dh) tensors, the
        reference's layout."""
        cfg, dt = self.cfg, compute_dtype(self.cfg)
        B, Se, D = enc_out.shape
        # a place's block of the kv heads or head_dim under tensor
        # parallelism (its wk, wv blocks; a whole bias cut to its slice)
        tp = tensor_parallel()
        hd_cut = tp is not None and tp.layout.get("kv") == "hd"
        if tp is not None and tp.layout.get("kv") is not None:
            enc_out = tp.enter(enc_out)     # into the place's wk, wv blocks
        KV, hd = params["stack"][0]["xattn"]["wk"].shape[1:]
        # each layer's projection is written into its slice: the pair is
        # never held twice (1.18 GB at whisper-medium's B = 8)
        shape = (len(params["stack"]), B, Se, KV, hd)
        k = torch.empty(shape, dtype=dt, device=enc_out.device)
        v = torch.empty(shape, dtype=dt, device=enc_out.device)
        for l, p in enumerate(params["stack"]):
            p = TR._gathered(p["xattn"], "stack/xattn")
            for out, w, b in ((k, "wk", "bk"), (v, "wv", "bv")):
                t = (enc_out @ p[w].to(dt).reshape(D, KV * hd)).view(
                    B, Se, KV, hd)
                if b in p:
                    bias = (tp.enter(p[b])[:, tp.cut(p[b].shape[1])]
                            if hd_cut else p[b])
                    t = t + bias.to(dt)
                out[l] = t
        return k, v

    def _backbone(self, params, x, positions, *, caches=None,
                  cache_len=None, cross_kv=None):
        """The family's stack: (x, caches or states, aux), aux the MoE
        layers' auxiliary loss summed in float32 (zero for the recurrent
        families)."""
        cfg = self.cfg
        if cfg.family == "xlstm":
            x, st = TR.apply_xlstm_stack(params["stack"], x, cfg,
                                         states=caches)
        elif cfg.family == "hybrid":
            x, st = TR.apply_hybrid_stack(params["stack"], x, cfg,
                                          positions, states=caches,
                                          cache_len=cache_len)
        else:
            return TR.apply_dense_stack(params["stack"], x, cfg, positions,
                                        caches=caches, cache_len=cache_len,
                                        cross_kv=cross_kv)
        return x, st, torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------- train
    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy over labels >= 0, in float32, plus
        ``0.01 * aux / num_layers`` for the MoE family (aux the layers'
        load-balancing losses): (loss, {"loss", "tokens"}).  The
        encoder-decoder's batch carries ``frames``; the VLM's carries
        ``patches`` (B, P, D), put ahead of the tokens in the compute dtype
        with P unlabelled positions, so ``tokens`` counts text only."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        cross_kv = None
        if cfg.family == "encdec":
            cross_kv = self._cross_kv(params, self._encode(params,
                                                           batch["frames"]))
            x = self._positions_added(x)
        if cfg.family == "vlm":
            patches = batch["patches"].to(x.dtype)
            P = patches.shape[1]
            x = torch.cat([patches, x], dim=1)
            positions = torch.arange(S + P, dtype=torch.int32,
                                     device=x.device).expand(B, S + P)
            labels = torch.cat([torch.full((B, P), -1, dtype=labels.dtype,
                                           device=labels.device), labels],
                               dim=1)
        x, _, aux = self._backbone(params, x, positions, cross_kv=cross_kv)
        mask = (labels >= 0).float()
        tp = tensor_parallel()
        if tp is not None and tp.layout.get("head"):
            nll = self._nll_vocab_cut(params, x, labels, tp) * mask
        else:
            logits = self._logits(params, x).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[
                ..., 0]
            nll = (logz - gold) * mask
        nll, tok = torch.sum(nll), torch.sum(mask)
        ctx = current_rules()
        if ctx is not None and ctx[1].get("batch") is not None:
            # the place's rows: both sums over the global batch, its
            # places added in rank order
            from ..launch.mesh import axis_group, ordered_sum

            nll, tok = ordered_sum(torch.stack([nll, tok]), axis_group(
                ctx[0], ctx[1]["batch"])).unbind(0)
        loss = nll / torch.clamp(tok, min=1.0)
        if cfg.num_experts:
            loss = loss + 0.01 * aux / torch.full(
                (), float(max(cfg.num_layers, 1)), device=aux.device)
        return loss, {"loss": loss, "tokens": tok}

    # ------------------------------------------------------------- serve
    def init_cache(self, batch: int, cache_seq: int, ring: bool = False):
        """{"k", "v"}: (L, B, cache_seq, KV, dh) zeros in the compute dtype
        (MLA: {"c_kv", "k_rope"}, ``transformer.init_kv_caches``).
        ``ring=True`` adds ``kpos`` (L, cache_seq) int32, filled with
        -2**30: the SWA ring buffer, whose slots ``decode_step`` reuses
        (slot ``pos % cache_seq``).  An MLA cache has no ring, as in the
        reference: there ``ring`` adds nothing.  The encoder-decoder's is
        {"self": {"k", "v"}, "cross": None}, ``cross`` filled by prefill
        (or by ``launch.serve._init_cache``); it takes no ring either, as
        in the reference.  The recurrent families' are their states:
        xLSTM's float32 (``transformer.init_xlstm_states``), the
        hybrid's in the compute dtype with a KV cache of ``cache_seq``
        slots a group (``init_hybrid_states``); neither takes a ring.
        Under the logical-axis rules (a place of a mesh) ``batch`` is the
        place's rows, and each leaf is the place's block of the global
        cache as ``launch.sharding.cache_specs`` cuts it
        (``_cache_block``)."""
        cfg, dev = self.cfg, torch.device(self.device)
        block = self._cache_block()
        if block is not None:
            batch = batch * axis_size("batch")
        if cfg.family == "xlstm":
            return TR.init_xlstm_states(cfg, batch, dev, block=block)
        if cfg.family == "hybrid":
            return TR.init_hybrid_states(cfg, batch, cache_seq, dev,
                                         dtype=compute_dtype(cfg),
                                         block=block)
        c = TR.init_kv_caches(self.cfg, batch, cache_seq, dev,
                              dtype=compute_dtype(self.cfg), block=block)
        if self.cfg.family == "encdec":
            return {"self": c, "cross": None}
        if ring and not self.cfg.mla:
            c["kpos"] = torch.full((self.cfg.num_layers, cache_seq), -(2**30),
                                   dtype=torch.int32, device=dev)
        return c

    @staticmethod
    def _cache_block():
        """Under the logical-axis rules (a place of a mesh): (path, global
        shape) -> the shape of the place's block of that cache leaf under
        ``launch.sharding.cache_specs`` (kv heads or head_dim, the latent's
        r and dr, the mLSTM value dim, Mamba2's heads and conv channels,
        the batch rows); None without rules (every leaf whole)."""
        ctx = current_rules()
        if ctx is None:
            return None
        from ..launch.sharding import cache_block_shape

        mesh = ctx[0]
        return lambda path, shape: cache_block_shape(path, shape, mesh)

    def _m_rows(self, states, batch: int):
        """The mLSTM m state (G, n_m, B, H) as a place steps it: ``cache_
        specs`` cuts its dim 1, n_m, over the batch axes where they divide
        it (the reference's rule for a 4-d state, which reads dim 1 as the
        batch), so a place holds every row of the global batch, for all
        blocks or for its share of them, while C and n hold its rows only.
        Returns (the states with m replaced by the place's rows of the
        whole m, gathered over m's axes in rank order, and a function that
        writes them back: the stepped rows gathered over the batch axes,
        the place's blocks of them copied into its m), or (states, None)
        where nothing is cut."""
        ctx = current_rules()
        if ctx is None:
            return states, None
        from ..launch.mesh import axis_group, axis_sizes, gather_cat
        from ..launch.sharding import (
            _cache_spec,
            batch_rows,
            block_slices,
            mesh_coords,
        )

        mesh, rules = ctx
        m = states["m"][2]
        n_m = TR._groups(self.cfg, self.cfg.xlstm_group)[1]
        B = batch * axis_size("batch")
        shape = (m.shape[0], n_m, B, m.shape[3])
        ax = _cache_spec("m/2", shape, mesh)[1]
        if ax is None and rules.get("batch") is None:
            return states, None
        whole = m if ax is None else gather_cat(m, axis_group(mesh, ax), 1)
        rows = whole[:, :, batch_rows(mesh, rules, B)].clone()

        def write_back():
            new = rows if rules.get("batch") is None else gather_cat(
                rows, axis_group(mesh, rules["batch"]), 2)
            a, b = block_slices(shape, (None, ax, None, None),
                                axis_sizes(mesh), mesh_coords(mesh))[1]
            m.copy_(new[:, a:b])

        return dict(states, m=states["m"][:2] + (rows,)), write_back

    def decode_step(self, params, batch):
        """One token against a populated cache, full or ring, or the
        recurrent families' states: (logits (B, V), cache), the cache
        written in place.  Attention stays on the plain route (one query
        against the cache).  The encoder-decoder adds the sinusoidal row
        at ``pos`` of a table of the self cache's length, writes the self
        cache and reads ``cache["cross"]``."""
        cfg = self.cfg
        token, pos, cache = batch["token"], int(batch["pos"]), batch["cache"]
        B = token.shape[0]
        x = self._embed(params, token)
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        if cfg.family == "encdec":
            table = LL.sinusoidal_on(cache["self"]["k"].shape[2],
                                     cfg.d_model, x.device)
            x = x + table[pos:pos + 1].to(x.dtype)
            x, _, _ = TR.apply_dense_stack(
                params["stack"], x, cfg, positions, caches=cache["self"],
                cache_len=pos, cross_kv=cache["cross"])
        else:
            states, write_back = (self._m_rows(cache, B)
                                  if cfg.family == "xlstm" else (cache, None))
            x, _, _ = self._backbone(params, x, positions, caches=states,
                                     cache_len=pos)
            if write_back is not None:
                write_back()
        logits = self._logits(params, x)
        if cfg.padded_vocab != cfg.vocab_size:
            # never sample a padding row
            logits[..., cfg.vocab_size:] = LL.NEG_INF
        return logits[:, 0], cache

    def prefill(self, params, batch, flash: bool = True):
        """Populate a cache from a full prompt: (last-position logits,
        cache).  ``flash=True`` routes every layer's attention to the flash
        kernel (one launch per layer on a CUDA tensor; its plain version
        on the CPU); ``flash=False`` takes the reference's
        ``cfg.attn_impl`` route.  The encoder-decoder runs the encoder on
        ``batch["frames"]`` and projects its cross (k, v) first; with
        ``flash=True`` its encoder layers, decoder self-attention and
        cross-attention each launch the kernel (Le + 2 Ld launches).  Its
        cache is {"self": {"k", "v"}, "cross": (k, v)}.  The VLM's is the
        dense prefill of the text (no patches, as in the reference).  The
        recurrent families raise, as the reference does: their parallel
        form does not carry final states out, and the serving loop warms
        them by stepping ``decode_step`` over the prompt."""
        if self.cfg.family in ("xlstm", "hybrid"):
            raise NotImplementedError(
                "prefill for recurrent families goes through launch/serve.py")
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache_seq = batch.get("cache_seq", S)
        x = self._embed(params, tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        caches = self.init_cache(B, cache_seq)
        if self.cfg.family == "encdec":
            cross = self._cross_kv(params, self._encode(
                params, batch["frames"], flash=flash))
            x, _, _ = TR.apply_dense_stack(
                params["stack"], self._positions_added(x), self.cfg,
                positions, caches=caches["self"], cache_len=0,
                cross_kv=cross, flash=flash)
            caches["cross"] = cross
            cache = caches
        else:
            x, cache, _ = TR.apply_dense_stack(params["stack"], x, self.cfg,
                                               positions, caches=caches,
                                               cache_len=0, flash=flash)
        logits = self._logits(params, x[:, -1:])
        return logits[:, 0], cache


_FAMILIES = ("dense", "moe", "encdec", "vlm", "xlstm", "hybrid")


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of a configuration of any family on ``device`` (default:
    the card)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"build_model(device={str(device)!r}) needs a CUDA device and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "path")
    return Model(cfg, device)


# ---------------------------------------------------------------- input specs
# the reference's workload shapes (repro/models/model.py)
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether a configuration runs at a shape, and why not: full attention
    skips ``long_500k`` (quadratic, an unbounded KV cache); the recurrent
    families and a sliding window run it."""
    SHAPES[shape]   # an unknown shape raises KeyError, as in the reference
    if shape == "long_500k" and cfg.family not in ("xlstm", "hybrid") \
            and not cfg.swa_window:
        return False, ("full attention is quadratic/unbounded-KV at 500k "
                       "(skip per assignment)")
    return True, ""


def input_specs(cfg: ModelConfig, shape) -> dict:
    """Stand-ins for every model input of a (configuration, shape) cell:
    tensors on ``torch.device("meta")``, shapes and dtypes only, nothing
    allocated.  Train and prefill: ``tokens`` and ``labels`` (B, S) int32,
    with ``frames`` (B, encoder_seq, D) for the encoder-decoder and
    ``patches`` (B, num_patches, D) for the VLM, in the compute dtype.
    Decode: ``token`` (B, 1) int32, ``pos`` a 0-d int32 tensor and
    ``cache``, ``Model.init_cache`` at the shape's sequence length: the SWA
    ring of ``swa_window`` slots at ``long_500k`` where the configuration
    has a window, and the encoder-decoder's cross cache, a (k, v) pair of
    (L, B, encoder_seq, KV, head_dim).  (The reference's ``dp_devices``,
    which it never reads, is left out.)  ``shape`` is a name of
    ``SHAPES`` or a dict of its form (``kind``, ``batch``, ``seq``; a
    decode's ``seq`` its cache's length, and ``ring`` True for the SWA
    ring)."""
    info = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = info["batch"], info["seq"]
    meta = torch.device("meta")
    f = compute_dtype(cfg)

    def sd(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device=meta)

    if info["kind"] in ("train", "prefill"):
        batch = {"tokens": sd((B, S)), "labels": sd((B, S))}
        if cfg.family == "encdec":
            batch["frames"] = sd((B, cfg.encoder_seq, cfg.d_model), f)
        if cfg.family == "vlm":
            batch["patches"] = sd((B, cfg.num_patches, cfg.d_model), f)
        return batch
    ring = bool(cfg.swa_window) and (shape == "long_500k" if isinstance(
        shape, str) else info.get("ring", False))
    cache_seq = min(S, cfg.swa_window) if ring else S
    cache = Model(cfg, meta).init_cache(B, cache_seq, ring=ring)
    if cfg.family == "encdec":
        kv = TR.init_kv_caches(cfg, B, cfg.encoder_seq, meta, dtype=f)
        cache["cross"] = (kv["k"], kv["v"])
    return {"token": sd((B, 1)), "pos": sd(()), "cache": cache}
