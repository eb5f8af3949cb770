"""Step builders and abstract input specs for every (architecture ×
shape) — the JAX package's ``launch/steps.py``:

  * train:   the MBS train step (the paper's technique): the planner's
             split, loss normalization and one optimizer update;
  * prefill: the full-sequence forward that builds the decode cache;
  * decode:  one new token against a ``seq_len`` cache.

A :class:`StepBundle` holds the step and its arguments as **meta-device
tensors** — the torch twin of ``jax.ShapeDtypeStruct``: shape and dtype,
no storage — so a bundle for grok-1-314b allocates nothing. Also here:
the loss of every family (``make_loss_fn``) and a family's train batch as
data (``family_batch`` / ``device_split``, the data twin of
:func:`abstract_train_batch`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import engine, optim, tree
from ..configs.shapes import InputShape
from ..core import losses
from ..data import LMDataset
from ..models import encdec, nn, transformer
from ..models import remat as remat_lib
from ..models.config import ModelConfig
from . import mesh as mesh_lib, sharding

N_VISION_TOKENS = 256  # stubbed patch embeddings a sample (qwen2-vl)
AUDIO_TGT_FRACTION = 4  # enc-dec training: decoder length = seq / 4


def make_loss_fn(cfg: ModelConfig, dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: Optional[str] = None):
    """``loss_fn(params, mb, exact_denom=None) -> (loss, {"aux_loss"})``.
    Pass the plan's ``remat_policy`` so the loss checkpoints the way the
    planner admitted it. An enc-dec batch holds ``frames`` and
    ``tgt_tokens``; a VLM batch may add ``vision_embeds`` and
    ``mrope_positions`` (one micro-batch's (3, N_mu, S)) to ``tokens``.

    MoE configs add the router's load-balance term, ``router_aux_coef ·
    aux / num_layers``. Under exact normalization micro-batch losses must
    sum to the mini-batch's, so that term, which is not per sample,
    carries the micro-batch's share of the valid samples
    (``n_valid / exact_denom``): every executor then weights it alike,
    whatever the split."""
    if not cfg.is_encdec:
        transformer.check_supported(cfg)
    policy = remat_lib.resolve(remat, remat_policy)

    def loss_fn(params, mb, exact_denom=None):
        sw = mb.get("sample_weight")
        if cfg.is_encdec:
            logits, aux = encdec.forward(params, cfg, mb["frames"],
                                         mb["tgt_tokens"], dtype=dtype,
                                         remat_policy=policy)
        else:
            logits, aux = transformer.forward(
                params, cfg, mb["tokens"],
                vision_embeds=mb.get("vision_embeds"),
                mrope_positions=mb.get("mrope_positions"), dtype=dtype,
                remat_policy=policy)
        loss = losses.cross_entropy(logits, mb["labels"], sample_weight=sw,
                                    exact_denom=exact_denom)
        if cfg.is_moe:
            aux_term = cfg.router_aux_coef * aux / cfg.num_layers
            if exact_denom is not None:
                n_valid = (torch.sum(sw) if sw is not None
                           else float(tree.leaves(mb)[0].shape[0]))
                aux_term = aux_term * (n_valid / exact_denom)
            loss = loss + aux_term
        return loss, {"aux_loss": aux}

    return loss_fn


def make_staged_loss(cfg: ModelConfig, dtype=torch.bfloat16,
                     remat: bool = True,
                     remat_policy: Optional[str] = None) -> engine.StagedLoss:
    """The decoder-only transformer loss as the prelude / stage_fn /
    finale triple that :class:`engine.PipelinedExecutor` schedules.

    The stage boundary is the period axis: ``params["blocks"]`` leaves are
    stacked ``(num_periods, ...)`` and ``StagedLoss.partition`` cuts them
    into ``(stages, periods_per_stage, ...)``; a stage runs its periods as
    :func:`transformer.forward` runs the whole stack, under the same
    checkpoint lattice. The finale returns the RAW loss sum
    (``exact_denom=1``): the executor divides by the global valid count
    after its all-reduce.

    Families whose forward does not cut at period boundaries with one
    ``(B, S, d_model)`` carry are refused, as the reference refuses them:
    MoE (the router's aux loss accumulates across periods into the loss),
    enc-dec (two stacks joined by cross attention) and VLM (the vision
    frontend feeds the embedding)."""
    if cfg.is_encdec or cfg.is_moe or cfg.is_vlm:
        which = ("enc-dec" if cfg.is_encdec else
                 "MoE" if cfg.is_moe else "VLM")
        raise ValueError(
            f"{cfg.name}: pipeline staging supports dense decoder-only "
            f"stacks; {which} forwards do not factor into "
            "prelude/stage_fn/finale with a (B, S, d_model) carry — run "
            "this family on the data axis (ShardedExecutor) instead")
    transformer.check_supported(cfg)
    policy = remat_lib.resolve(remat, remat_policy)

    def prelude(shared, mb):
        return transformer._embed_inputs(shared, cfg, mb["tokens"], None,
                                         dtype)

    def period_fn(x, slot_params):
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for kind, p in zip(cfg.layer_pattern, slot_params):
            x, _, _ = transformer._apply_slot(p, cfg, kind, x, positions,
                                              dtype=dtype,
                                              remat_policy=policy)
        return x

    period_fn = remat_lib.checkpoint_period(period_fn, policy)

    def stage_fn(stage_p, x):
        for slot_params in transformer._periods(stage_p):
            x = period_fn(x, slot_params)
        return x

    def finale(shared, x, mb):
        x = nn.rmsnorm(shared["final_norm"], x, cfg.norm_eps)
        logits = transformer._lm_head(shared, cfg, x)
        loss = losses.cross_entropy(logits, mb["labels"],
                                    sample_weight=mb.get("sample_weight"),
                                    exact_denom=1.0)
        return loss, {}

    return engine.StagedLoss(num_layers=cfg.num_periods, prelude=prelude,
                             stage_fn=stage_fn, finale=finale,
                             stacked_key="blocks")


# ---------------------------------------------------------------------------
# the step bundle and its abstract arguments
# ---------------------------------------------------------------------------

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A step and its arguments.

    ``fn`` is the port's eager step: the executor's ``step_split`` for a
    train bundle (``plan``, ``optimizer``, ``loss_fn`` and ``executor``
    say what it was built against), the prefill or decode closure
    otherwise. ``arg_shapes`` are ``fn``'s arguments as meta-device
    tensor trees. ``donate_argnums`` keeps the reference's values; here
    they name the arguments the step consumes: a train step returns the
    state that replaces its params and optimizer state (``flat`` writes
    them in place) and the split batch is spent after it; a decode step
    writes its cache in place and returns it. A caller drops its own
    references to those arguments.

    ``runner`` is the object ``fn`` is a method of: a train bundle's
    executor (its ``prepare``, where it has one, cuts the
    reference-format state), a :class:`GspmdServe` for a prefill or
    decode on a GSPMD mesh (its ``prepare`` places the whole arguments);
    None for a prefill or decode on one device."""
    kind: str
    fn: Callable
    arg_shapes: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...] = ()
    plan: Optional[Any] = None
    optimizer: Optional[Any] = None
    loss_fn: Optional[Callable] = None
    executor: Optional[str] = None
    runner: Optional[Any] = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig):
    """The family's ``init_params`` tree as meta tensors. A generator
    cannot live on the meta device, so ``init_params`` is traced under a
    fake-tensor mode (``memory_model.param_shapes``), which allocates
    nothing either."""
    from ..core import memory_model
    return tree.map(lambda x: _meta(x.shape, x.dtype),
                    memory_model.param_shapes(cfg))


def make_optimizer(cfg: ModelConfig, lr: float = 1e-3) -> optim.Optimizer:
    """The production default, the paper's optimizer: SGD with momentum
    0.9 and weight decay 5e-4."""
    return optim.sgd(lr, momentum=0.9, weight_decay=5e-4)


def abstract_opt_state(optimizer, params_shapes):
    """``optimizer.init`` over a meta tree: the state's meta tree."""
    return optimizer.init(params_shapes)


def abstract_train_batch(cfg: ModelConfig, seq_len: int, plan, *,
                         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta tree of a split ``(N_Smu, N_mu, ...)`` train batch: tokens and
    labels; an enc-dec config's ``frames`` and target tokens of
    ``seq_len // AUDIO_TGT_FRACTION``; a VLM's ``vision_embeds`` (N_Smu,
    N_mu, N_VISION_TOKENS, VISION_EMBED_DIM) and ``mrope_positions``
    (N_Smu, 3, N_mu, S) — :func:`device_split`'s layout — and the
    ``sample_weight`` mask the plan's split always emits. ``N_mu`` is a
    data-parallel plan's ``local_micro``: what one rank's step takes."""
    s = seq_len
    n, m = plan.num_micro_batches, plan.local_micro
    i32, f32 = torch.int32, torch.float32
    if cfg.is_encdec:
        t = s // AUDIO_TGT_FRACTION
        batch = {"frames": _meta((n, m, s, cfg.d_model), dtype),
                 "tgt_tokens": _meta((n, m, t), i32),
                 "labels": _meta((n, m, t), i32)}
    else:
        batch = {"tokens": _meta((n, m, s), i32),
                 "labels": _meta((n, m, s), i32)}
        if cfg.is_vlm:
            batch["vision_embeds"] = _meta(
                (n, m, N_VISION_TOKENS, transformer.VISION_EMBED_DIM), dtype)
            batch["mrope_positions"] = _meta((n, 3, m, s), i32)
    batch["sample_weight"] = _meta((n, m), f32)
    return batch


def build_train_step(cfg: ModelConfig, shape: InputShape, *,
                     num_microbatches: Optional[int] = None, optimizer=None,
                     dtype=torch.bfloat16, remat: bool = True,
                     remat_policy: Optional[str] = None,
                     normalization: str = "paper",
                     executor: str = "compiled", mesh=None,
                     fsdp: Optional[bool] = None,
                     fsdp_over_pod: bool = False,
                     calibrate: str = "off",
                     budget_bytes: Optional[int] = None,
                     tuning_cache: Optional[str] = None,
                     device="cuda") -> StepBundle:
    """The train step through the MBS engine, as the reference builds it:
    ``plan_mbs`` sizes the micro-batch (``num_microbatches=None``: from
    the memory model; a ragged split is padded and masked) and chooses
    the policy (``remat_policy="auto"``), and the loss is built with the
    plan's policy. The port's planner arguments pass through:
    ``calibrate``, ``budget_bytes`` (default: the memory of CUDA
    ``device``), ``tuning_cache`` and ``device``. ``executor`` names the
    executor; a ``mesh`` with a data extent above 1 wraps it in
    ``engine.ShardedExecutor`` (params replicated, so the plan is made
    with ``fsdp_params=False``), and the batch is one rank's block.

    A mesh whose model axis is larger than 1 routes through the pipeline
    instead, as the reference's does: ``plan_mbs(pipeline=True)`` budgets
    stage-local activations × the in-flight depth, and
    :class:`engine.PipelinedExecutor` runs the plan's micro-batches
    through the 1F1B schedule over :func:`make_staged_loss`.
    ``executor`` is then "pipelined", the bundle's ``fn`` its
    ``step_split`` (call the executor's ``prepare`` on the
    reference-format state first) and the abstract state the
    reference-format trees.

    A GSPMD mesh (``launch.mesh.gspmd_mesh``, ``make_production_mesh``)
    places the step as the reference's dry run does: params and optimizer
    state by ``param_specs`` (``fsdp_over_pod`` with a pod axis), the
    batch by ``batch_specs`` — ``plan_mbs(mesh=, fsdp_params=fsdp)``
    plans it — and :class:`engine.GspmdExecutor` runs ``executor`` on
    each rank's blocks. ``executor`` is then "gspmd";
    ``runner.prepare`` cuts the reference-format state.

    ``fsdp`` shards the params over the data axis; ``None`` takes the
    mesh's default, the reference's: on a GSPMD mesh FSDP is on
    (``fsdp=False`` is its dry run's ``--no-fsdp``: the params replicated
    over the batch axes, tensor-parallel over ``model`` only), on a
    pipeline mesh off (``fsdp=True`` is its launcher's ``--fsdp``); on
    one device or a data-parallel mesh the params are whole on every
    rank and ``fsdp`` is ignored, as in the reference."""
    optimizer = optimizer or make_optimizer(cfg)
    mode = getattr(mesh, "mode", None)
    pipeline = mode == "pipeline" and mesh_lib.axis_size(
        mesh, mesh_lib.MODEL_AXIS) > 1
    gspmd = mode == "gspmd"
    if fsdp is None:
        fsdp = gspmd
    dp = mesh_lib.data_parallel_size(mesh) if mesh is not None else 1
    plan = engine.plan_mbs(
        shape.global_batch, num_microbatches=num_microbatches,
        model_cfg=cfg, seq_len=shape.seq_len, budget_bytes=budget_bytes,
        device=device, normalization=normalization,
        act_bytes=torch.empty((), dtype=dtype).element_size(), remat=remat,
        remat_policy=remat_policy,
        mesh=mesh if dp > 1 or pipeline or gspmd else None,
        fsdp_params=fsdp if gspmd else dp < 2 or pipeline,
        calibrate=calibrate, tuning_cache=tuning_cache, executor=executor,
        pipeline=pipeline,
        **optim.memory_model_kw(optimizer, fused=executor == "flat"))
    if pipeline:
        staged = make_staged_loss(cfg, dtype, remat_policy=plan.remat_policy)
        ex = engine.PipelinedExecutor(staged, optimizer, plan, mesh=mesh,
                                      fsdp=fsdp)
        executor, loss_fn = "pipelined", None
    elif gspmd:
        loss_fn = make_loss_fn(cfg, dtype, remat_policy=plan.remat_policy)
        ex = engine.GspmdExecutor(loss_fn, optimizer, plan, mesh=mesh,
                                  inner=executor, fsdp=fsdp,
                                  fsdp_over_pod=fsdp_over_pod)
        executor = "gspmd"
    else:
        loss_fn = make_loss_fn(cfg, dtype, remat_policy=plan.remat_policy)
        if dp > 1:
            ex = engine.ShardedExecutor(loss_fn, optimizer, plan, mesh=mesh,
                                        inner=executor)
        else:
            ex = engine.get_executor(executor)(loss_fn, optimizer, plan)
    params = abstract_params(cfg)
    return StepBundle(
        "train", ex.step_split,
        (params, abstract_opt_state(optimizer, params),
         abstract_train_batch(cfg, shape.seq_len, plan, dtype=dtype)),
        donate_argnums=(0, 1, 2), plan=plan, optimizer=optimizer,
        loss_fn=loss_fn, executor=executor, runner=ex)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def _global_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    return (cfg.long_context_global_window if shape.name == "long_500k"
            else None)


class GspmdServe:
    """A prefill or decode step on a GSPMD mesh, placed as the reference's
    dry run places it (``_in_specs`` / ``_out_specs``): the params by
    ``param_specs`` (FSDP over ``data``), a decode cache by
    ``cache_specs(stacked=True)``, the tokens, positions, frames and
    patches by ``cache_specs(stacked=False)``; the logits come out split
    as ``cache_specs(stacked=False)`` splits them (vocab over ``model``,
    batch over the batch axes) and a prefill's cache as the decode cache.

    :meth:`prepare` turns the step's whole arguments (every rank holding
    the same values; meta or fake tensors in a dry run) into this rank's
    DTensors; :meth:`step` (the bundle's ``fn``) runs the step on them
    inside ``models.nn.use_mesh``; :meth:`gather` brings an output back
    whole."""

    def __init__(self, kind: str, fn: Callable, mesh):
        if getattr(mesh, "mode", None) != "gspmd":
            raise ValueError(f"GspmdServe runs on a GSPMD mesh "
                             f"(launch.mesh.gspmd_mesh), got {mesh!r}")
        self.kind, self._fn, self.mesh = kind, fn, mesh

    def place_params(self, params, device=None):
        """This rank's DTensors of whole ``params`` (``param_specs``)."""
        return sharding.place_tree(
            params, sharding.param_specs(params, self.mesh), self.mesh,
            self.mesh.device if device is None else torch.device(device))

    def place(self, x, *, stacked: bool = False, device=None):
        """This rank's DTensors of a whole tree of inputs or a cache
        (``cache_specs``: ``stacked`` for a cache's period-stacked
        leaves)."""
        if x is None:
            return None
        return sharding.place_tree(
            x, sharding.cache_specs(x, self.mesh, stacked=stacked),
            self.mesh,
            self.mesh.device if device is None else torch.device(device))

    def prepare(self, params, *args, device=None):
        """This rank's DTensors of ``(params, *args)`` (the bundle's
        arguments, whole), on ``device`` (default: the mesh's)."""
        return (self.place_params(params, device),) + tuple(
            self.place(a, stacked=self.kind == "decode" and i == 1,
                       device=device)  # a decode's cache
            for i, a in enumerate(args))

    def step(self, *placed):
        """The step on :meth:`prepare`'s DTensors."""
        with nn.use_mesh(self.mesh):
            return self._fn(*placed)

    @staticmethod
    def gather(t):
        """The whole tensors of an output tree, on every rank (a
        collective every rank calls)."""
        return sharding.full_tree(t)


def build_prefill_step(cfg: ModelConfig, shape: InputShape, *,
                       dtype=torch.bfloat16, remat_policy: str = "none",
                       mesh=None) -> StepBundle:
    """The prefill: ``transformer.prefill`` (last-token logits and the
    decode cache; ``long_500k`` under ``cfg.long_context_global_window``)
    — an enc-dec config's encoder and teacher-forced decoder, returning
    the last position's logits. ``remat_policy`` reaches the enc-dec
    forward (the reference's default "none": forward only). A GSPMD
    ``mesh`` makes ``fn`` a :class:`GspmdServe`'s ``step``; the
    arguments stay the whole (meta) ones, which its ``prepare`` places."""
    s, b = shape.seq_len, shape.global_batch
    i32 = torch.int32
    if cfg.is_encdec:
        @nn.serving_mode
        def fn(params, frames, tokens):
            logits, _ = encdec.forward(params, cfg, frames, tokens,
                                       dtype=dtype,
                                       remat_policy=remat_policy)
            return logits[:, -1]

        args = (abstract_params(cfg), _meta((b, s, cfg.d_model), dtype),
                _meta((b, s // AUDIO_TGT_FRACTION), i32))
    else:
        gw = _global_window(cfg, shape)

        def fn(params, tokens, vision_embeds=None, mrope_positions=None):
            return transformer.prefill(params, cfg, tokens, max_len=s,
                                       vision_embeds=vision_embeds,
                                       mrope_positions=mrope_positions,
                                       dtype=dtype, global_window=gw)

        args = [abstract_params(cfg), _meta((b, s), i32)]
        if cfg.is_vlm:
            args += [_meta((b, N_VISION_TOKENS,
                            transformer.VISION_EMBED_DIM), dtype),
                     _meta((3, b, s), i32)]
        args = tuple(args)
    serve = GspmdServe("prefill", fn, mesh) if mesh is not None else None
    return StepBundle("prefill", serve.step if serve else fn, args,
                      runner=serve)


def abstract_cache(cfg: ModelConfig, shape: InputShape,
                   dtype=torch.bfloat16):
    """The decode cache's meta tree: ``transformer.init_cache`` on the
    meta device, or the enc-dec cache's layout (``encdec.init_decode_cache``:
    self-attention rings over ``seq_len``, cross keys and values over
    ``seq_len // AUDIO_TGT_FRACTION`` encoder frames)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        K, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
        T = s // AUDIO_TGT_FRACTION
        return {"self": {"k": _meta((L, b, s, K, hd), dtype),
                         "v": _meta((L, b, s, K, hd), dtype),
                         "pos": _meta((L, b, s), torch.int32)},
                "cross": {"k": _meta((L, b, T, K, hd), dtype),
                          "v": _meta((L, b, T, K, hd), dtype)}}
    return transformer.init_cache(cfg, b, s, dtype,
                                  global_window=_global_window(cfg, shape),
                                  device=META)


def build_decode_step(cfg: ModelConfig, shape: InputShape, *,
                      dtype=torch.bfloat16, mesh=None) -> StepBundle:
    """One decode step, ``fn(params, token (B, 1), cache, pos (B,))`` →
    (logits, cache), the cache written in place. A GSPMD ``mesh`` makes
    ``fn`` a :class:`GspmdServe`'s ``step`` (see
    :func:`build_prefill_step`)."""
    b = shape.global_batch
    if cfg.is_encdec:
        def fn(params, token, cache, pos):
            return encdec.decode_step(params, cfg, token, cache, pos,
                                      dtype=dtype)
    else:
        gw = _global_window(cfg, shape)

        def fn(params, token, cache, pos):
            return transformer.decode_step(params, cfg, token, cache, pos,
                                           dtype=dtype, global_window=gw)

    serve = GspmdServe("decode", fn, mesh) if mesh is not None else None
    args = (abstract_params(cfg), _meta((b, 1), torch.int32),
            abstract_cache(cfg, shape, dtype), _meta((b,), torch.int32))
    return StepBundle("decode", serve.step if serve else fn, args,
                      donate_argnums=(2,), runner=serve)


def build_step(cfg: ModelConfig, shape: InputShape, *,
               num_microbatches: Optional[int] = 8, dtype=torch.bfloat16,
               **kw) -> StepBundle:
    """The shape's step: train (``kw`` to :func:`build_train_step`),
    prefill (under ``kw``'s ``remat_policy``, "none" for "auto": there is
    no planner to choose) or decode. A GSPMD ``mesh`` in ``kw`` places a
    prefill or decode step on it (:class:`GspmdServe`); serving takes no
    other mesh."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, num_microbatches=num_microbatches,
                                dtype=dtype, **kw)
    mesh = kw.get("mesh")
    if mesh is not None and getattr(mesh, "mode", None) != "gspmd":
        raise ValueError(f"a {shape.kind} step is placed on a GSPMD mesh "
                         f"only, got {mesh!r}")
    if shape.kind == "prefill":
        policy = kw.get("remat_policy") or "none"
        return build_prefill_step(
            cfg, shape, dtype=dtype,
            remat_policy="none" if policy == "auto" else policy, mesh=mesh)
    return build_decode_step(cfg, shape, dtype=dtype, mesh=mesh)


# ---------------------------------------------------------------------------
# a family's train batch (the data twin of the reference's
# ``abstract_train_batch``)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """The family's ``init_params``: ``encdec``'s or ``transformer``'s."""
    init = encdec.init_params if cfg.is_encdec else transformer.init_params
    return init(cfg, seed=seed, device=device)


def mrope_positions(batch: int, seq_len: int, n_vis: int) -> np.ndarray:
    """qwen2-vl's M-RoPE streams (3, batch, seq_len) int32 for an image
    prefix of ``n_vis`` patches, then text: patch j of a grid ``w`` wide
    (w = ceil(sqrt(n_vis))) sits at (t, h, w) = (0, j // w, j % w); text
    token i after the image at start + i in all three streams, start one
    past the largest image position."""
    w = math.isqrt(n_vis - 1) + 1 if n_vis else 1
    j = np.arange(n_vis)
    img = np.stack([np.zeros_like(j), j // w, j % w])  # (3, n_vis)
    start = int(img.max()) + 1 if n_vis else 0
    text = np.arange(seq_len - n_vis) + start
    pos = np.concatenate([img, np.broadcast_to(text, (3, text.size))], 1)
    return np.broadcast_to(pos[:, None].astype(np.int32),
                           (3, batch, seq_len)).copy()


def family_batch(cfg: ModelConfig, seq_len: int, batch_size: int, *,
                 seed: int = 0, vision: bool = True
                 ) -> Dict[str, np.ndarray]:
    """A host mini-batch of ``cfg``'s family from ``seed``: an enc-dec
    config's ``frames`` (B, seq_len, d_model) fp32 with ``tgt_tokens`` and
    ``labels`` of seq_len // AUDIO_TGT_FRACTION; otherwise ``LMDataset``'s
    tokens and labels, and for a VLM (``vision``) ``vision_embeds`` (B,
    n_vis, VISION_EMBED_DIM) fp32, n_vis = min(N_VISION_TOKENS, seq_len),
    and their ``mrope_positions`` (3, B, seq_len)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        t = seq_len // AUDIO_TGT_FRACTION
        toks = LMDataset(cfg.vocab_size, t, seed=seed).batch(batch_size, 0)
        return {"frames": rng.standard_normal(
                    (batch_size, seq_len, cfg.d_model), np.float32),
                "tgt_tokens": toks["tokens"], "labels": toks["labels"]}
    batch = LMDataset(cfg.vocab_size, seq_len, seed=seed).batch(batch_size,
                                                                 0)
    if cfg.is_vlm and vision:
        n_vis = min(N_VISION_TOKENS, seq_len)
        batch["vision_embeds"] = rng.standard_normal(
            (batch_size, n_vis, transformer.VISION_EMBED_DIM), np.float32)
        batch["mrope_positions"] = mrope_positions(batch_size, seq_len,
                                                   n_vis)
    return batch


def device_split(plan, batch: Dict[str, np.ndarray], device,
                 dtype=None) -> Dict[str, torch.Tensor]:
    """``plan.device_split`` of a family batch, float leaves cast to
    ``dtype``. The plan's split cuts every leaf on axis 0, so the (3, B,
    S) ``mrope_positions`` stay out of it and are split here on their
    batch axis into (N_Smu, 3, N_mu, S); a ragged plan, which would pad
    them, is refused."""
    rest = {k: v for k, v in batch.items() if k != "mrope_positions"}
    out = plan.device_split(rest, device)
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() and
               k != "sample_weight" else v for k, v in out.items()}
    pos = batch.get("mrope_positions")
    if pos is not None:
        if plan.pad:
            raise ValueError(
                f"mrope_positions: a ragged plan pads the last micro-batch "
                f"({plan.describe()}); split the streams uniformly")
        n_s, n_mu = plan.num_micro_batches, plan.micro_batch_size
        s = np.asarray(pos).reshape(3, n_s, n_mu, pos.shape[-1])
        out["mrope_positions"] = torch.from_numpy(np.ascontiguousarray(
            s.transpose(1, 0, 2, 3))).to(device)
    return out
