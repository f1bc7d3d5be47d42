"""Spawned gloo worlds for the port's multi-device tests.

``run_world`` starts ``world`` processes (``torch.multiprocessing``, spawn)
that join one gloo group through a file under the test's ``tmp_path`` (no
TCP port, so parallel test workers cannot clash), run the named cases of
this module on a payload of numpy arrays, and pickle each rank's results
back. A case that raises records its traceback instead, so one failing case
does not take the others down. This module imports no JAX: the ranks run
the port alone, and the tests hold their results against the JAX package
in the pytest process.
"""

from __future__ import annotations

import contextlib
import datetime
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120


class CaseError(RuntimeError):
    pass


def run_world(tmp_path: Path, world: int, cases, payload) -> dict:
    """{case: [rank 0's result, rank 1's, ...]} for every case in order."""
    import torch.multiprocessing as mp

    tmp_path = Path(tmp_path)
    with open(tmp_path / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    mp.start_processes(_rank_main, args=(world, str(tmp_path), list(cases)),
                       nprocs=world, join=True, start_method="spawn")
    per_rank = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    return {c: [res[c] for res in per_rank] for c in cases}


@contextlib.contextmanager
def one_rank_group(tmp_path: Path):
    """A gloo group of this process alone, torn down on exit."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init1",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def results(world_results: dict, case: str) -> list:
    """A case's per-rank results; raises with the first rank's traceback if
    the case failed there."""
    out = world_results[case]
    for r, res in enumerate(out):
        if isinstance(res, CaseError):
            raise AssertionError(f"case {case!r} failed on rank {r}:\n{res}")
    return out


def _rank_main(rank: int, world: int, directory: str, cases) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/init", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(Path(directory) / "payload.pkl", "rb") as f:
        payload = pickle.load(f)
    out = {}
    for case in cases:
        try:
            out[case] = CASES[case](payload)
        except Exception:  # recorded for the test that reads this case
            out[case] = CaseError(traceback.format_exc())
    with open(Path(directory) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ----------------------------------------------------------------------------
# helpers the cases share
# ----------------------------------------------------------------------------


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else t


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(kw, **extra):
    from flash_attention_softmax_n_tpu_torch.models import DecoderConfig
    return DecoderConfig(**{**kw, **extra}, dtype=torch.float32)


def _params(payload, key="params"):
    from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
    return params_from_jax(payload[key], device="cpu")


def _slab(x, mesh, dims):
    """x's slice for this rank: ``dims`` maps a dim to its mesh axis."""
    from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
        axis_index,
        axis_size,
    )
    for dim, axis in dims.items():
        n = x.shape[dim] // axis_size(mesh, axis)
        x = x.narrow(dim, axis_index(mesh, axis) * n, n)
    return x


def _train(payload, mesh, steps, lr=1e-2, cfg_extra=None, tokens="tokens",
           **kw):
    from flash_attention_softmax_n_tpu_torch.parallel import make_train_step
    cfg = _cfg(payload["cfg"], **(cfg_extra or {}))
    init, step = make_train_step(cfg, mesh, learning_rate=lr, **kw)
    params, opt = init(_params(payload))
    toks = _t(payload[tokens]).long()
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
    return params, opt, losses


# ----------------------------------------------------------------------------
# the 8-rank world
# ----------------------------------------------------------------------------


def case_mesh(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        initialize_distributed,
        local_mesh,
        make_mesh,
    )
    from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
        make_hybrid_mesh,
    )
    mesh = make_mesh({"data": 2, "model": 4})
    hybrid = make_hybrid_mesh({"dcn_data": 2}, {"data": 2, "model": 2})
    raised = []
    for fn in (lambda: make_mesh({"data": 64, "model": 64}),
               lambda: make_hybrid_mesh({"dcn_data": 64}, {"model": 64})):
        try:
            fn()
            raised.append(None)
        except ValueError as e:
            raised.append(str(e))
    # an up group of the same world is a no-op; any other world raises
    initialize_distributed("file:///nonexistent", dist.get_world_size(),
                           dist.get_rank(), device="cpu")
    try:
        initialize_distributed("file:///nonexistent", 3, 0, device="cpu")
        other = None
    except RuntimeError as e:
        other = str(e)
    return {"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape),
            "coord": mesh.get_coordinate(),
            "hybrid_names": hybrid.mesh_dim_names,
            "hybrid_shape": tuple(hybrid.mesh.shape),
            "hybrid_ranks": hybrid.mesh.tolist(),
            "local_shape": tuple(local_mesh(4).mesh.shape),
            "raised": raised, "other_world": other}


def case_tp_forward(payload):
    from flash_attention_softmax_n_tpu_torch.models import decoder_forward
    from flash_attention_softmax_n_tpu_torch.parallel import (
        decoder_param_specs,
        make_mesh,
        shard_pytree,
    )
    mesh = make_mesh({"data": 2, "model": 4})
    cfg = _cfg(payload["cfg"])
    params = _params(payload)
    local = shard_pytree(params, decoder_param_specs(params), mesh)
    tokens = _slab(_t(payload["tokens"]).long(), mesh, {0: "data"})
    with torch.no_grad():
        logits = decoder_forward(local, cfg, tokens, tp_mesh=mesh)
    return {"logits": _np(logits),
            "shapes": {k: tuple(local[k].shape)
                       for k in ("embed", "lm_head", "final_norm")},
            "wq": tuple(local["layers"]["wq"].shape),
            "wo": tuple(local["layers"]["wo"].shape)}


def case_fused_projections_raise(payload):
    from flash_attention_softmax_n_tpu_torch.models import decoder_forward
    from flash_attention_softmax_n_tpu_torch.parallel import (
        decoder_param_specs,
        make_mesh,
        shard_pytree,
    )
    from flash_attention_softmax_n_tpu_torch.quant import (
        fuse_decoder_projections,
    )
    mesh = make_mesh({"data": 2, "model": 4})
    fused = fuse_decoder_projections(_params(payload))
    local = shard_pytree(fused, decoder_param_specs(fused), mesh)
    try:
        decoder_forward(local, _cfg(payload["cfg"]), _t(payload["tokens"][:2]).long(),
                        tp_mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def case_quantized_shard(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        decoder_param_specs,
        make_mesh,
        shard_pytree,
    )
    from flash_attention_softmax_n_tpu_torch.quant import (
        quantize_decoder_weights,
    )
    mesh = make_mesh({"data": 2, "model": 4})
    q = quantize_decoder_weights(_params(payload), bits=8)
    specs = decoder_param_specs(q)
    local = shard_pytree(q, specs, mesh)
    wq = local["layers"]["wq"]
    full = q["layers"]["wq"]
    return {"spec": specs["layers"]["wq"].values,
            "scale_spec": specs["layers"]["wq"].scales,
            "values": tuple(wq.values.shape), "scales": tuple(wq.scales.shape),
            "equal": bool(torch.equal(wq.values, _slab(full.values, mesh,
                                                        {2: "model"})))}


def _meshed_flash(payload, key, grads=False, **kw):
    from flash_attention_softmax_n_tpu_torch.ops.flash_attention import (
        flash_attention_n,
    )
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 2, "model": 4})
    q, k, v = (_slab(_t(a), mesh, {0: "data", 1: "model"})
               for a in payload[key])
    for t in (q, k, v):
        t.requires_grad_(grads)
    extra = {}
    bias = None
    if "bias" in kw:
        bias = _t(kw.pop("bias")).requires_grad_(grads)
        extra["attn_bias"] = bias
    if "attn_mask" in kw:
        extra["attn_mask"] = _t(kw.pop("attn_mask"))
    out = flash_attention_n(q, k, v, softmax_n_param=1.0,
                            implementation="pallas", mesh=mesh, **extra, **kw)
    res = {"out": _np(out)}
    if grads:
        ct = _slab(_t(payload[key + "_ct"]), mesh, {0: "data", 1: "model"})
        torch.sum(out * ct).backward()
        res.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
        if bias is not None:
            res["dbias"] = _np(bias.grad)
    return res


def case_meshed_flash(payload):
    return _meshed_flash(payload, "qkv", attn_mask=payload["mask"])


def case_meshed_flash_grads(payload):
    return _meshed_flash(payload, "qkv_small", grads=True,
                         bias=payload["bias"], is_causal=True)


def case_meshed_dropout(payload):
    from flash_attention_softmax_n_tpu_torch.ops.flash_attention import (
        flash_attention_n,
    )
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 2, "model": 4})
    full = [_t(a) for a in payload["qkv"]]
    seed = torch.tensor(payload["seed"], dtype=torch.int32)
    kw = dict(softmax_n_param=1.0, is_causal=True, dropout_p=0.35,
              dropout_seed=seed, implementation="pallas")
    one = flash_attention_n(*full, **kw)
    slabs = [_slab(t, mesh, {0: "data", 1: "model"}) for t in full]
    slab = flash_attention_n(*slabs, mesh=mesh, **kw)
    kept = flash_attention_n(*slabs, mesh=mesh, **{**kw, "dropout_p": 0.0})
    return {"bit_equal": bool(torch.equal(
        slab, _slab(one, mesh, {0: "data", 1: "model"}))),
        "differs": not torch.allclose(slab, kept)}


def case_meshed_dropout_grads(payload):
    seed = torch.tensor(payload["seed"], dtype=torch.int32)
    return _meshed_flash(payload, "qkv_small", grads=True, is_causal=True,
                         dropout_p=0.25, dropout_seed=seed)


def case_meshed_bias_indivisible(payload):
    from flash_attention_softmax_n_tpu_torch.ops.flash_attention import (
        flash_attention_n,
    )
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 2, "model": 4})
    q = torch.zeros((1, 2, 32, 32))
    try:
        # a bias of 6 heads over slabs of 2 heads on 4 ranks
        flash_attention_n(q, q, q, attn_bias=torch.zeros((1, 6, 32, 32)),
                          implementation="pallas", mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def case_train_tp_dp(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 2, "model": 4})
    _, _, losses = _train(payload, mesh, 3)
    _, _, auto = _train(payload, mesh, 2,
                        cfg_extra={"attn_implementation": "auto"})
    return {"losses": losses, "auto": auto}


def case_train_sp(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 2, "model": 2, "sp": 2})
    _, _, losses = _train(payload, mesh, 2, sp_axis="sp")
    try:
        _train(payload, make_mesh({"data": 2, "model": 4}), 1, sp_axis="sp")
        missing = None
    except ValueError as e:
        missing = str(e)
    return {"losses": losses, "missing": missing}


def case_train_zero1(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
        zero1_opt_shardings,
    )
    mesh = make_mesh({"data": 4, "model": 2})
    p0, o0, plain = _train(payload, mesh, 3)
    p1, o1, zero = _train(payload, mesh, 3, zero1=True)
    owners = zero1_opt_shardings(o1, p1, mesh)
    # the moments this rank holds equal the replicated optimizer's
    held, equal = [], True
    for name in p1["layers"]:
        a, b = p1["layers"][name], p0["layers"][name]
        if a in o1.optim.state:
            held.append(name)
            for m in ("exp_avg", "exp_avg_sq"):
                equal &= bool(torch.allclose(o1.optim.state[a][m],
                                             o0.state[b][m], rtol=1e-5,
                                             atol=1e-9))
    return {"plain": plain, "zero": zero, "held": held, "equal": equal,
            "owners": owners["layers"], "n_state": len(o1.optim.state),
            "n_params": len(list(o1.param_groups[0]["params"]))}


def case_train_hybrid(payload):
    from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
        make_hybrid_mesh,
    )
    mesh = make_hybrid_mesh({"dcn_data": 2}, {"data": 2, "model": 2})
    _, _, losses = _train(payload, mesh, 2, dcn_data_axis="dcn_data")
    return {"losses": losses}


def case_finetune_dropout(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_mesh,
        make_train_step,
    )
    mesh = make_mesh({"data": 2, "model": 4})
    cfg = _cfg(payload["cfg"], attn_dropout=0.2)
    toks = _t(payload["tokens"]).long()
    losses = {}
    for name, m, seed in (("l1", mesh, 7), ("l2", mesh, 7), ("l3", mesh, 8),
                          ("eval", mesh, None), ("one", None, 7)):
        init, step = make_train_step(cfg, m, learning_rate=1e-3)
        params, opt = init(_params(payload))
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        before = params["layers"]["wq"].detach().clone()
        params, opt, loss = step(params, opt, toks, generator=gen)
        losses[name] = float(loss)
        if name == "l1":
            losses["moved"] = bool((params["layers"]["wq"] != before).any())
    return losses


def case_remat_grads(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        causal_lm_loss,
        decoder_param_specs,
        make_mesh,
        shard_pytree,
    )
    mesh = make_mesh({"data": 2, "model": 4})
    params = _params(payload)
    toks = _t(payload["tokens_long"]).long()
    out = {}
    for remat in (False, True):
        local = shard_pytree(params, decoder_param_specs(params), mesh)
        leaves = [local["embed"], local["layers"]["wq"], local["layers"]["w_down"],
                  local["lm_head"]]
        for t in leaves:
            t.requires_grad_(True)
        loss = causal_lm_loss(local, _cfg(payload["cfg"], remat=remat), toks,
                              tp_mesh=mesh)
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (float(loss), [_np(g) for g in grads])
    return out


def case_ring_combined(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_mesh,
        ring_attention_n,
    )
    mesh = make_mesh({"data": 2, "model": 2, "sp": 2})
    q, k, v = (_slab(_t(a), mesh, {0: "data", 1: "model", 2: "sp"})
               for a in payload["qkv_ring"])
    out = ring_attention_n(q, k, v, mesh=mesh, axis_name="sp",
                           softmax_n_param=1.0, is_causal=True,
                           implementation="pallas")
    return _np(out)


def case_sp_train_pallas_remat(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 2, "model": 2, "sp": 2})
    _, _, losses = _train(payload, mesh, 1, lr=1e-3, tokens="tokens_long",
                          cfg_extra={"attn_implementation": "pallas",
                                     "remat": True}, sp_axis="sp")
    return {"losses": losses}


# ----------------------------------------------------------------------------
# the 4-rank world: ring attention over {"sp": 4}
# ----------------------------------------------------------------------------


def _ring(payload, key, grads=False, **kw):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_mesh,
        ring_attention_n,
    )
    mesh = make_mesh({"sp": 4})
    q, k, v = (_slab(_t(a), mesh, {2: "sp"}) for a in payload[key])
    for t in (q, k, v):
        t.requires_grad_(grads)
    out = ring_attention_n(q, k, v, mesh=mesh, axis_name="sp", **kw)
    res = {"out": _np(out)}
    if grads:
        ct = _slab(_t(payload[key + "_ct"]), mesh, {2: "sp"})
        torch.sum(out * ct).backward()
        res.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
    return res


def case_ring_oracle(payload):
    return {(impl, n, causal): _ring(payload, "qkv", softmax_n_param=n,
                                     is_causal=causal, implementation=impl)
            for impl in ("xla", "pallas") for n in (0.0, 1.0)
            for causal in (False, True)}


def case_ring_grads(payload):
    return {(impl, n): _ring(payload, "qkv_g", grads=True, softmax_n_param=n,
                             is_causal=True, implementation=impl)
            for impl in ("xla", "pallas") for n in (0.0, 1.0)}


def case_ring_gqa(payload):
    return {impl: _ring(payload, "qkv_gqa", grads=True, softmax_n_param=1.0,
                        is_causal=True, implementation=impl)
            for impl in ("xla", "pallas", "auto")}


def case_ring_plus_n(payload):
    return _ring(payload, "qkv_const", softmax_n_param=4.0, is_causal=False,
                 implementation="xla")


def case_ring_padding(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_mesh,
        ring_attention_n,
    )
    mesh = make_mesh({"sp": 4})
    q, k, v = (_t(a) for a in payload["qkv_pad"])
    true_len = payload["true_len"]
    outs = []
    for length in (q.shape[2], true_len):
        qs, ks, vs = (_slab(t[:, :, :length], mesh, {2: "sp"})
                      for t in (q, k, v))
        out = ring_attention_n(qs, ks, vs, mesh=mesh, axis_name="sp",
                               softmax_n_param=1.0, is_causal=True)
        outs.append(_np(out))
    return outs


def case_ring_errors(payload):
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_mesh,
        ring_attention_n,
    )
    mesh = make_mesh({"sp": 4})
    x = torch.zeros((1, 2, 4, 32))
    calls = {
        "mask": (NotImplementedError, lambda: ring_attention_n(
            x, x, x, mesh=mesh, attn_mask=torch.ones((1, 1, 16, 16), dtype=bool))),
        "impl": (ValueError, lambda: ring_attention_n(
            x, x, x, mesh=mesh, implementation="fast")),
        "ev": (ValueError, lambda: ring_attention_n(
            x, x, x[..., :8], mesh=mesh, implementation="pallas")),
    }
    out = {}
    for name, (exc, fn) in calls.items():
        try:
            fn()
            out[name] = None
        except exc as e:
            out[name] = str(e)
    return out



# ----------------------------------------------------------------------------
# the 4-rank world of the checkpoint tests: {"data": 2, "model": 2}
# ----------------------------------------------------------------------------


def _adamw(leaves):
    return torch.optim.AdamW(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def case_train_resume(payload):
    """4 steps straight, against 2 steps, a save from the ZeRO-1 TP x DP
    sharded state, a load onto the mesh and 2 more steps."""
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_mesh,
        make_train_step,
    )
    from flash_attention_softmax_n_tpu_torch.utils.checkpoint import (
        load_train_checkpoint,
        save_train_checkpoint,
    )
    mesh = make_mesh({"data": 2, "model": 2})
    cfg = _cfg(payload["cfg"])
    toks = _t(payload["tokens"]).long()
    init, step = make_train_step(cfg, mesh, optimizer=_adamw, zero1=True)

    def run(n, params, opt):
        losses = []
        for _ in range(n):
            params, opt, loss = step(params, opt, toks)
            losses.append(float(loss))
        return params, opt, losses

    _, _, straight = run(4, *init(_params(payload)))
    params, opt, first = run(2, *init(_params(payload)))
    save_train_checkpoint(payload["dir"], cfg, params, opt, step=2,
                          metadata={"run": "test"}, mesh=mesh)
    cfg2, params, opt, step_r, meta = load_train_checkpoint(
        payload["dir"], _adamw, device="cpu", mesh=mesh, zero1=True)
    _, _, resumed = run(2, params, opt)
    return {"straight": straight, "resumed": first + resumed,
            "same_cfg": cfg2 == cfg, "step": step_r, "meta": meta,
            "wq": tuple(params["layers"]["wq"].shape)}


# ----------------------------------------------------------------------------
# the 8-rank serving world: {"data": 2, "model": 4}
# ----------------------------------------------------------------------------


def _serving_mesh():
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    return make_mesh({"data": 2, "model": 4})


def _data_index(mesh):
    from flash_attention_softmax_n_tpu_torch.parallel.mesh import axis_index
    return axis_index(mesh, "data")


def case_sharded_decode(payload):
    """make_sharded_decode over this rank's slots: dense, int8 and fp8
    caches, 8 steps (the tail mode) from lengths 8, the cache not donated;
    then the per-slot sampling variant on the dense cache."""
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_sharded_decode,
        shard_engine_state,
    )
    from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
        init_quantized_kv_cache,
    )
    mesh = _serving_mesh()
    cfg = _cfg(payload["serve_cfg"])
    params = _params(payload, "serve_params")
    b, s = 4, 64
    tok = _slab(torch.arange(b, dtype=torch.int32) + 3, mesh, {0: "data"})
    active = torch.ones((b // 2,), dtype=torch.bool)
    out = {}
    for mode in (None, "int8", "fp8"):
        if mode is None:
            cache = {"k": _t(payload["decode_k"]), "v": _t(payload["decode_v"])}
        else:
            cache = init_quantized_kv_cache(cfg.n_layers, b, cfg.n_kv_heads, s,
                                            cfg.head_dim, mode=mode,
                                            device="cpu")
            cache.pop("length")
        cache["lengths"] = torch.full((b,), 8, dtype=torch.int32)
        sp, sc = shard_engine_state(params, cache, mesh)
        if mode is None:
            dense = sc
        loop = make_sharded_decode(cfg, mesh, num_steps=8, donate=False)
        toks, after, _ = loop(sp, tok, sc, active)
        out[mode] = {"tokens": toks.numpy(), "lengths": after["lengths"].numpy(),
                     "kept": sc["lengths"].numpy(),
                     "k_shape": tuple((sc["k"].values if mode else sc["k"]).shape)}
    loop = make_sharded_decode(cfg, mesh, num_steps=8, donate=False,
                               per_slot_sampling=True)
    rows = {0: "data"}
    temps = _slab(torch.tensor([0.0, 1.5, 0.0, 2.0]), mesh, rows)
    top_k = _slab(torch.tensor([0, 8, 0, 0]), mesh, rows)
    top_p = _slab(torch.tensor([1.0, 1.0, 1.0, 0.9]), mesh, rows)
    gen = torch.Generator().manual_seed(3 + _data_index(mesh))
    toks, _, _ = loop(sp, tok, dense, active, gen, temps, top_k, top_p)
    out["sampled"] = toks.numpy()
    loop = make_sharded_decode(cfg, mesh, num_steps=8, donate=False,
                               temperature=1.5)
    gen = torch.Generator().manual_seed(5 + _data_index(mesh))
    out["tempered"] = loop(sp, tok, dense, active, gen)[0].numpy()
    return out


def case_sharded_argmax(payload):
    """K2 over this rank's vocab columns and the cross-shard merge, on the
    rank's rows: random weights, and two planted ties across shards."""
    from flash_attention_softmax_n_tpu_torch.engine import engine
    from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor
    mesh = _serving_mesh()
    out = {}
    for name, (x, values, scales) in payload["argmax"].items():
        lm = QTensor(_slab(_t(values), mesh, {1: "model"}),
                     _slab(_t(scales), mesh, {1: "model"}), bits=8)
        xl = _slab(_t(x), mesh, {0: "data"})
        out[name] = engine._sharded_lm_head_argmax(xl, lm, mesh).numpy()
    return out


def case_meshed_prefill(payload):
    """engine_prefill_batch on this rank's shards and slots (K1's plain
    version on its heads): logits, its cache rows and lengths."""
    from flash_attention_softmax_n_tpu_torch.engine import engine_prefill_batch
    from flash_attention_softmax_n_tpu_torch.parallel import shard_engine_state
    mesh = _serving_mesh()
    cfg = _cfg(payload["prefill_cfg"])
    params = _params(payload, "prefill_params")
    b, s = 4, 32
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
             "lengths": torch.zeros((b,), dtype=torch.int32)}
    sp, sc = shard_engine_state(params, cache, mesh)
    rows = {0: "data"}
    logits, sc = engine_prefill_batch(
        sp, cfg, _slab(_t(payload["prefill_tokens"]).long(), mesh, rows),
        _slab(_t(payload["prefill_lens"]), mesh, rows),
        torch.arange(b // 2), sc, mesh=mesh)
    return {"logits": _np(logits), "k": _np(sc["k"]),
            "lengths": sc["lengths"].numpy()}


def _serve_meshed(payload, key, prompts, budgets, *, register=(), prewarm=None,
                  **engine_kw):
    """Requests served by InferenceEngine(mesh=) on this rank: {request id:
    tokens}, the counters, and prewarm's count if asked for."""
    from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
    from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor
    mesh = _serving_mesh()
    cfg = _cfg(payload[key + "_cfg"])
    eng = InferenceEngine(cfg, _params(payload, key + "_params"), mesh=mesh,
                          device="cpu", **engine_kw)
    variants = eng.prewarm(loop_steps=prewarm) if prewarm else None
    for p in register:
        eng.register_prefix(p)
    for p, n in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=n)
    done = eng.run_until_done(loop_steps=8)
    kv = eng.cache["k"]
    return {"tokens": {r.request_id: r.output for r in done},
            "counters": eng.counters_report(), "variants": variants,
            "next_token": tuple(eng._next_token.shape),
            "cache": tuple((kv.values if isinstance(kv, QTensor) else kv).shape)}


def case_engine_mesh(payload):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8], [2, 7]]
    return _serve_meshed(payload, "serve", prompts, [6, 7, 8, 9], max_batch=4,
                         max_len=64)


def case_engine_fused_argmax(payload):
    """int8 weights, vocab 96: the fused loop's greedy tokens through K2 on
    each vocab shard and the merge (its calls counted)."""
    from flash_attention_softmax_n_tpu_torch.engine import engine
    calls = [0]
    merge = engine._sharded_lm_head_argmax

    def counted(*a, **k):
        calls[0] += 1
        return merge(*a, **k)

    engine._sharded_lm_head_argmax = counted
    try:
        prompts = [[3, 1, 4, 1], [9, 2], [5, 3, 5], [2, 7, 1, 8]]
        out = _serve_meshed(payload, "q96", prompts, [6] * 4, max_batch=4,
                            max_len=64)
    finally:
        engine._sharded_lm_head_argmax = merge
    cfg = _cfg(payload["q96_cfg"])
    out["fusable"] = engine._greedy_fusable(
        _params(payload, "q96_params"), cfg, _serving_mesh(), 4)
    out["merges"] = calls[0]
    return out


def case_engine_chunked(payload):
    return _serve_meshed(payload, "serve", payload["chunked_prompts"], [5, 5],
                         max_batch=2, max_len=64, prefill_chunk=16)


def case_engine_pallas_prefill(payload):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    return _serve_meshed(payload, "serve_auto", prompts, [5, 6], max_batch=2,
                         max_len=64)


def case_engine_prewarm(payload):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8], [2, 7]]
    return _serve_meshed(payload, "eng", prompts, [6, 7, 8, 9], prewarm=8,
                         max_batch=4, max_len=64)


def case_engine_prefix(payload):
    out = {}
    for kvq in (None, "int8"):
        out[kvq] = _serve_meshed(payload, "eng", payload["prefix_prompts"],
                                 [6] * 4, register=[payload["prefix"]],
                                 max_batch=4, max_len=128, prefill_chunk=16,
                                 kv_quantization=kvq)
    return out


def case_engine_all_kernel(payload):
    """int8 weights and KV on the all-kernel route (K7 on the column and
    row shards, K9 on the d_ff shard, K8 on the local heads, K2 and the
    merge), with the shapes K9 saw."""
    from flash_attention_softmax_n_tpu_torch.models import decoder
    seen = []
    fused = decoder.fused_mlp_matmul

    def counted(x, wg, *rest):
        seen.append((tuple(x.shape), tuple(wg.shape)))
        return fused(x, wg, *rest)

    decoder.fused_mlp_matmul = counted
    try:
        out = _serve_meshed(payload, "all", payload["all_prompts"], [7, 5, 9, 6],
                            max_batch=4, max_len=64, kv_quantization="int8")
    finally:
        decoder.fused_mlp_matmul = fused
    out["fused_mlp"] = sorted(set(seen))
    out["fused_calls"] = len(seen)
    return out


def case_serving_rejections(payload):
    """shard_engine_state's rejections (JAX's messages), and a piggyback
    payload passed to a meshed loop."""
    from flash_attention_softmax_n_tpu_torch.engine import engine_decode_loop
    from flash_attention_softmax_n_tpu_torch.parallel import (
        make_mesh,
        shard_engine_state,
    )
    from flash_attention_softmax_n_tpu_torch.quant import (
        fuse_decoder_projections,
    )
    mesh = _serving_mesh()
    params = _params(payload, "serve_params")

    def cache(b, kvh):
        shape = (2, b, kvh, 64, 8)
        return {"k": torch.zeros(shape), "v": torch.zeros(shape),
                "lengths": torch.zeros((b,), dtype=torch.int32)}

    calls = {
        "axis": lambda: shard_engine_state(params, cache(4, 4),
                                           make_mesh({"data": 2, "sp": 4})),
        "batch": lambda: shard_engine_state(params, cache(3, 4), mesh),
        "heads": lambda: shard_engine_state(params, cache(4, 2), mesh),
        "fused": lambda: shard_engine_state(fuse_decoder_projections(params),
                                            cache(4, 4), mesh),
        "piggy": lambda: engine_decode_loop(
            params, _cfg(payload["serve_cfg"]), torch.zeros(2, dtype=torch.int32),
            cache(2, 4), torch.zeros(2, dtype=torch.bool), num_steps=8,
            mesh=mesh, p_tokens=torch.zeros((1, 8), dtype=torch.int32),
            p_slots=torch.zeros(1, dtype=torch.int32),
            p_true_lens=torch.ones(1, dtype=torch.int32)),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
