"""One rank of the port's multi-process CPU tests (gloo, one thread).

    python tests/torch_parallel_worker.py <folder> <case> [<case> ...]

The tests start it through ``parallel/launch.py:run_local``, which sets the
torchrun variables. Each rank joins the group with
``initialize_distributed`` (a world of one by ``join_local``), reads
``<folder>/inputs.pt`` if the test wrote one, runs the named cases in order
and writes what each case returns to ``<folder>/out_<rank>.pt``. A case
checks what it can alone with ``assert``: a failing rank exits non-zero and
``run_local`` stops the group. This file imports no JAX: the tests compare
the outputs with the JAX package in their own process.
"""

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch.distributed as dist  # noqa: E402

from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig  # noqa: E402
from channelestimationtransformer_torch.core.runtime import stream_generator  # noqa: E402
from channelestimationtransformer_torch.models.informer import build_informer  # noqa: E402
from channelestimationtransformer_torch.parallel import launch  # noqa: E402
from channelestimationtransformer_torch.parallel.mesh import (  # noqa: E402
    batch_sharding,
    make_mesh,
    replicate_sharding,
)

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _flat_params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _replicated(t):
    """``t`` equal on every rank (bit for bit)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return all(torch.equal(parts[0], p) for p in parts)


@case
def launch_env(inputs, initialized):
    """JAX tests/test_launch_distributed.py: the group came up from the
    environment, the batch splits, and an all-reduce sums the ranks' shards."""
    assert initialized and dist.get_world_size() == 2
    assert launch.per_host_batch(256) == 128
    total = torch.full((1, 4), float(dist.get_rank()) + 1.0).sum()
    dist.all_reduce(total)
    assert float(total) == 12.0, float(total)
    return {"total": float(total)}


@case
def mesh(inputs, initialized):
    """JAX test_make_mesh_shapes, and the placements of the two shardings."""
    from torch.distributed.tensor import Replicate, Shard

    n = dist.get_world_size()
    m = make_mesh()
    assert dict(zip(m.mesh_dim_names, m.shape)) == {"data": n, "model": 1, "seq": 1}
    m2 = make_mesh(data=n // 2, model=2)
    assert m2["model"].size() == 2 and m2["data"].size() == n // 2
    errors = []
    for kwargs in (dict(data=3, model=5), dict(model=3), dict(data=n, seq=2)):
        try:
            make_mesh(**kwargs)
        except ValueError as e:
            errors.append(str(e))
    assert len(errors) == 3, errors
    assert batch_sharding(m) == (Shard(0), Replicate(), Replicate())
    assert replicate_sharding(m) == (Replicate(),) * 3
    return {"errors": errors}


@case
def sharding(inputs, initialized):
    """Each parameter's placement at model=2, and ``shard_params``' DTensors
    gathered back equal to the parameters."""
    from torch.distributed.tensor import Replicate, Shard

    from channelestimationtransformer_torch.parallel.sharding import param_shardings, shard_params

    model = build_informer(InformerConfig(**inputs["sharding_cfg"]), device="cpu")
    mesh = make_mesh(data=dist.get_world_size() // 2, model=2)
    placements = param_shardings(model, mesh)
    shards = shard_params(model, mesh)
    params = dict(model.named_parameters())
    for name, dt in shards.items():
        assert torch.equal(dt.full_tensor(), params[name]), name
        rows = params[name].shape[0] if params[name].ndim else 1
        want = rows // 2 if placements[name] == Shard(0) else rows
        assert (dt.to_local().shape[0] if dt.ndim else 1) == want, name
    names = {Shard(0): "Shard(0)", Replicate(): "Replicate()"}
    return {"placements": {n: names[p] for n, p in placements.items()}}


@case
def ring(inputs, initialized):
    """``ring_attention`` over all ranks on the seq axis, causal and not."""
    from channelestimationtransformer_torch.parallel.ring import ring_attention

    m = make_mesh(data=1, model=1, seq=dist.get_world_size())
    q, k, v = inputs[f"ring_qkv_{dist.get_world_size()}"]
    with torch.no_grad():
        return {causal: ring_attention(q, k, v, m, causal=causal) for causal in (False, True)}


@case
def ring_grad(inputs, initialized):
    """dQ, dK and dV of ``sum(ring_attention(q, k, v) * cotangent)`` over
    all ranks on the seq axis, causal and not."""
    from channelestimationtransformer_torch.parallel.ring import ring_attention

    n = dist.get_world_size()
    m = make_mesh(data=1, model=1, seq=n)
    qkv, cot = inputs[f"ring_qkv_{n}"], inputs[f"ring_cot_{n}"]
    out = {}
    for causal in (False, True):
        leaves = [t.clone().requires_grad_() for t in qkv]
        (ring_attention(*leaves, m, causal=causal) * cot).sum().backward()
        out[causal] = [t.grad for t in leaves]
    return out


def _sgd_step(cfg, state_dict, batch, mesh=None, tp_mesh=None):
    """One ``_update`` (SGD at lr 1, so the parameters after it carry the
    gradients whole) of the model of ``cfg`` with ``state_dict``, built
    over ``mesh`` (a ring model), or made tensor-parallel over
    ``tp_mesh``; returns the model and the step's metrics."""
    from channelestimationtransformer_torch.parallel.tensor import tensor_parallel
    from channelestimationtransformer_torch.train.trainer import TrainState, _update

    model = build_informer(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(state_dict)
    if tp_mesh is not None:
        tensor_parallel(model, tp_mesh)
    state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=1.0),
                       schedule=lambda count: 1.0)
    metrics = _update(state, *batch, torch.Generator().manual_seed(0))
    return model, metrics


def _params_close(got, want, names=None):
    bad = [k for k in (names or want) if not torch.allclose(got[k], want[k], rtol=2e-4,
                                                           atol=2e-5)]
    assert not bad, bad


def _zero_gradient(name, names):
    """Whether the parameter ``name`` has a zero gradient in exact arithmetic:
    an attention key bias (softmax is invariant to a shift along the keys),
    a distilling conv's bias and the LayerNorm bias before that conv (the
    BatchNorm after it takes off any per-channel constant); or is the
    BatchNorm's running mean, which such a bias shifts."""
    if name.endswith("key.bias") or (".distil_" in name and name.endswith(
            (".bias", ".running_mean"))):
        return True
    head, _, tail = name.rpartition(".layer_")
    i, _, rest = tail.partition(".")
    return rest == "norm2.bias" and f"{head}.distil_{i}.bias" in names


def _trained_close(got, want, tc):
    """Two models' parameters after ``tc``'s Adam run: within rtol 2e-4 /
    atol 2e-5, but those of :func:`_zero_gradient`. Adam's first steps move
    such a parameter by up to ``lr`` a step on rounding noise alone: they
    are held to ``lr`` times the steps."""
    keys = [k for k in want if _zero_gradient(k, want)]
    _params_close(got, want, [k for k in want if k not in keys
                              and not k.endswith("num_batches_tracked")])
    bound = tc.lr * tc.num_epochs * tc.steps_per_epoch
    assert all((got[k] - want[k]).abs().max() <= bound for k in keys)


@case
def ring_train(inputs, initialized):
    """One ``_update`` of the ring Informer (JAX test_ring_informer_matches_full's
    config, dropout 0) against the full model's with the same weights and
    batch: loss and every parameter after the step; the ring's parameters
    the same on every rank."""
    n = dist.get_world_size()
    cfg = InformerConfig(**inputs["ring_cfg"])
    batch = inputs["ring_batch"]
    ring, m_ring = _sgd_step(InformerConfig(**inputs["ring_cfg"], attn="ring"),
                             inputs["ring_state"], batch, mesh=make_mesh(data=1, model=1, seq=n))
    full, m_full = _sgd_step(cfg, inputs["ring_state"], batch)
    assert torch.allclose(m_ring["loss"], m_full["loss"], rtol=2e-4), (m_ring, m_full)
    _params_close(ring.state_dict(), full.state_dict())
    assert _replicated(_flat_params(ring))
    return {"state": ring.state_dict(), "loss": float(m_ring["loss"])}


@case
def ring_trainer(inputs, initialized):
    """``Trainer(mesh=...)`` on a seq-axis mesh: the ring model trains two
    epochs (dropout 0.1, Adam), every rank's parameters the same; with
    dropout 0 it ends where the full model's Trainer on the same mesh ends."""
    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.train.trainer import Trainer

    n = dist.get_world_size()
    m = make_mesh(data=1, model=1, seq=n)
    h = torch.randn(8, 20, 16, generator=torch.Generator().manual_seed(1))
    data = [WindowDataset(h=x, seq_len=12, pred_len=2, snr_db=20.0, device="cpu")
            for x in (h[:6], h[6:])]
    out = {}
    for dropout in (0.1, 0.0):
        runs = {}
        for attn in (("ring", "full") if dropout == 0.0 else ("ring",)):
            cfg = InformerConfig(seq_len=12, label_len=4, pred_len=2, d_model=16, n_heads=2,
                                 e_layers=(2,), d_layers=1, d_ff=16, distil=False,
                                 dropout=dropout, attn=attn)
            tc = TrainConfig(batch_size=4, num_epochs=2, steps_per_epoch=2, log_every=2)
            t = Trainer(build_informer(cfg, device="cpu", seed=0, mesh=m), cfg, tc, *data,
                        mesh=m, log=lambda msg: None)
            runs[attn] = (t.fit(), t.model)
            assert _replicated(_flat_params(t.model))
            assert all(torch.isfinite(torch.tensor(e["nmse"])) for e in runs[attn][0])
        out[dropout] = [e["nmse"] for e in runs["ring"][0]]
    full_hist, full = runs["full"]
    assert _close_lists([e["nmse"] for e in full_hist], out[0.0])
    _trained_close(runs["ring"][1].state_dict(), full.state_dict(), tc)
    return out


def _close_lists(got, want, rel=2e-4):
    """Two lists of floats, element for element within ``rel``."""
    return len(got) == len(want) and all(abs(a - b) <= rel * abs(b) for a, b in zip(got, want))


def _tp_mesh():
    return make_mesh(data=1, model=dist.get_world_size())


@case
def tp_forward(inputs, initialized):
    """The tensor-parallel model (model axis = all ranks) against the
    replicated model with the same weights, eval mode, fused and unfused;
    each shard holds its rows of the full weight."""
    from channelestimationtransformer_torch.parallel.tensor import sharded_names, tensor_parallel

    out = {}
    for fused in (False, True):
        cfg = InformerConfig(**inputs["tp_cfg"], fuse_qkv=fused)
        state = inputs[f"tp_state_{fused}"]
        full = build_informer(cfg, device="cpu")
        full.load_state_dict(state)
        tp = build_informer(cfg, device="cpu")
        tp.load_state_dict(state)
        tensor_parallel(tp, _tp_mesh())
        names = sharded_names(tp)
        params = dict(tp.named_parameters())
        r, n = dist.get_rank(), dist.get_world_size()
        for name in names:
            rows = state[name].shape[0] // n
            assert torch.equal(params[name], state[name][r * rows:(r + 1) * rows]), name
        x_enc, x_dec, _ = inputs["tp_batch"]
        with torch.no_grad():
            got, want = tp(x_enc, x_dec), full(x_enc, x_dec)
        assert torch.allclose(got, want, rtol=2e-4, atol=2e-5), (got - want).abs().max()
        out[fused] = {"out": got, "sharded": sorted(names)}
    return out


@case
def tp_step(inputs, initialized):
    """One tensor-parallel ``_update`` (SGD at lr 1) against the replicated
    model's: each shard equals its rows of the replicated update, the
    replicated parameters' gradients are the same on every rank, and the
    gathered state dict is the replicated one. Then ``Trainer(mesh=...)``
    with a model axis: two epochs of Adam with dropout 0.1 against the
    replicated model's Trainer on a mesh of the same draws, and its
    checkpoint holds the full parameters and optimizer state."""
    import tempfile

    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.parallel.tensor import (
        full_state_dicts,
        replicated_grads_equal,
        sharded_names,
    )
    from channelestimationtransformer_torch.train.trainer import Trainer

    r, n = dist.get_rank(), dist.get_world_size()
    out = {}
    for fused in (False, True):
        cfg = InformerConfig(**inputs["tp_cfg"], fuse_qkv=fused)
        state = inputs[f"tp_state_{fused}"]
        tp, m_tp = _sgd_step(cfg, state, inputs["tp_batch"], tp_mesh=_tp_mesh())
        full, m_full = _sgd_step(cfg, state, inputs["tp_batch"])
        assert torch.allclose(m_tp["loss"], m_full["loss"], rtol=2e-4)
        assert replicated_grads_equal(tp)
        want = full.state_dict()
        local = tp.state_dict()
        for name in sharded_names(tp):
            rows = want[name].shape[0] // n
            want_rows = want[name][r * rows:(r + 1) * rows]
            assert torch.allclose(local[name], want_rows, rtol=2e-4, atol=2e-5), name
        gathered, _ = full_state_dicts(tp)
        _params_close(gathered, want, [k for k in want if not k.endswith("num_batches_tracked")])
        out[fused] = {"state": gathered, "loss": float(m_tp["loss"])}

    # The Trainer.
    cfg = InformerConfig(**dict(inputs["tp_cfg"], dropout=0.1))
    h = torch.randn(8, 40, 16, generator=torch.Generator().manual_seed(2))
    data = [WindowDataset(h=x, seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=20.0,
                          device="cpu") for x in (h[:6], h[6:])]
    folder = [tempfile.mkdtemp() if r == 0 else None]
    dist.broadcast_object_list(folder)
    runs = {}
    for name, mesh in (("tp", _tp_mesh()), ("replicated", make_mesh(data=1, model=1, seq=n))):
        tc = TrainConfig(batch_size=4, num_epochs=2, steps_per_epoch=2, log_every=2,
                         checkpoint_every_epochs=2, checkpoint_dir=f"{folder[0]}/{name}")
        t = Trainer(build_informer(cfg, device="cpu", seed=0), cfg, tc, *data, mesh=mesh,
                    log=lambda msg: None)
        runs[name] = (t.fit(), t)
    hist_tp, hist_rep = ([e["nmse"] for e in runs[k][0]] for k in ("tp", "replicated"))
    assert _close_lists(hist_tp, hist_rep), (hist_tp, hist_rep)
    if r == 0:
        saved = {k: torch.load(f"{folder[0]}/{k}/tmodel_2.pt", weights_only=True)
                 for k in runs}
        _trained_close(saved["tp"]["model"], saved["replicated"]["model"], tc)
        for i, st in saved["replicated"]["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                got = saved["tp"]["optimizer"]["state"][i][k]
                assert got.shape == st[k].shape, (i, k)
                assert torch.allclose(got, st[k], rtol=2e-4, atol=1e-7), (i, k)
    out["trainer"] = hist_tp
    return out


@case
def ring_informer(inputs, initialized):
    """The ring Informer of JAX test_ring_informer_matches_full's config
    with the flax full model's weights, in eval mode."""
    m = make_mesh(data=1, model=1, seq=dist.get_world_size())
    model = build_informer(InformerConfig(**inputs["ring_cfg"], attn="ring"), device="cpu",
                           mesh=m)
    model.load_state_dict(inputs["ring_state"])
    with torch.no_grad():
        return {"out": model(inputs["ring_x_enc"], inputs["ring_x_dec"])}


@case
def dp_update(inputs, initialized):
    """One DP ``_update`` of this rank's part of the global batch (SGD at lr
    1, so the parameters after the step carry the gradients whole), and two
    wrong variants: per-rank BatchNorm statistics, and the mean of per-rank
    NMSEs as the loss."""
    from channelestimationtransformer_torch.core.metrics import nmse, nmse_share
    from channelestimationtransformer_torch.models.encoder import batch_stats_group
    from channelestimationtransformer_torch.parallel.collectives import all_reduce_grads
    from channelestimationtransformer_torch.train.trainer import (
        TrainState,
        _update,
        apply_gradients,
    )

    group = make_mesh().get_group("data")
    p, r = dist.get_world_size(group), dist.get_rank(group)
    part = slice(r * inputs["dp_per_rank"], (r + 1) * inputs["dp_per_rank"])
    batch = [t[part] for t in inputs["dp_batch"]]
    out = {}
    for variant in ("dp", "per_rank_batch_stats", "mean_of_nmses"):
        model = build_informer(InformerConfig(**inputs["dp_cfg"]), device="cpu")
        model.load_state_dict(inputs["dp_state"])
        state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=1.0),
                           schedule=lambda count: 1.0)
        gen = torch.Generator().manual_seed(0)
        if variant == "dp":
            metrics = _update(state, *batch, gen, group)
            out["loss"] = float(metrics["loss"])
            out["split"] = metrics["loss_split"]
        else:
            model.train()
            with batch_stats_group(model, group if variant == "mean_of_nmses" else None):
                pred = model(batch[0], batch[1], generator=gen)
            loss = (nmse(pred, batch[2]) / p if variant == "mean_of_nmses"
                    else nmse_share(pred, batch[2], group))
            loss.backward()
            all_reduce_grads(model.parameters(), group)
            apply_gradients(state)
        assert _replicated(_flat_params(model))
        out[variant] = {"grads": {n: q.grad.clone() for n, q in model.named_parameters()},
                        "state": {k: v.clone() for k, v in model.state_dict().items()}}
    return out


def _chunk_dp_run(cfg, h, *, per_device_batch, num_steps, chunks, lr):
    """``train_chunk_dp`` from this rank's shard of ``h``: the chunks'
    losses, and the datasets and batch sizes its steps drew from."""
    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.train import trainer

    group = make_mesh().get_group("data")
    r = dist.get_rank(group)
    per = h.shape[0] // dist.get_world_size(group)
    shard = WindowDataset(h=h[r * per:(r + 1) * per], seq_len=cfg.seq_len,
                          pred_len=cfg.pred_len, snr_db=30.0, device="cpu")
    state = trainer.create_train_state(
        build_informer(cfg, device="cpu", seed=0),
        TrainConfig(batch_size=per_device_batch * dist.get_world_size(group), lr=lr,
                    schedule="constant"))
    drawn = []
    real = trainer.make_batch

    def spy(dataset, batch_size, label_len, **draws):
        drawn.append((dataset, batch_size))
        return real(dataset, batch_size, label_len, **draws)

    trainer.make_batch = spy
    try:
        losses = [float(trainer.train_chunk_dp(
            state, shard, num_steps=num_steps, per_device_batch=per_device_batch,
            label_len=cfg.label_len, generator=stream_generator("cpu", 1, c, r),
            group=group)["loss_sum"]) for c in range(chunks)]
    finally:
        trainer.make_batch = real
    assert all(d is shard and b == per_device_batch for d, b in drawn)
    assert len(drawn) == num_steps * chunks
    assert _replicated(_flat_params(state.model))
    assert _replicated(torch.tensor(losses))
    return losses


@case
def chunk_dp(inputs, initialized):
    """JAX test_train_chunk_dp_per_shard_sampling's model, data and batch:
    1 + 8 chunks of 8 steps of 4 windows a rank from its own shard. JAX's
    schedule (warmup 1, cosine to 0 over its 8 steps) stops training after
    the first chunk, so its loss falls only by the luck of the draws; here
    the lr is 1e-3 at every step, and the loss falls because it trains."""
    n = dist.get_world_size()
    cfg = InformerConfig(seq_len=16, label_len=4, pred_len=2, d_model=16, n_heads=2,
                         e_layers=(1,), d_layers=1, d_ff=16, distil=False)
    g = torch.Generator().manual_seed(0)
    t = torch.linspace(0, 1, (16 + 2 + 4) * 4 * n, dtype=torch.float64).reshape(4 * n, 22, 1)
    h = ((torch.sin(4 * t) + 0.01 * torch.randn(t.shape, generator=g, dtype=torch.float64))
         * torch.ones(1, 1, 16, dtype=torch.float64)).float()
    return {"losses": _chunk_dp_run(cfg, h, per_device_batch=4, num_steps=8, chunks=9,
                                      lr=1e-3)}


@case
def chunk_dp_pallas(inputs, initialized):
    """JAX test_train_chunk_dp_with_pallas_attention: use_pallas=True (here
    the bd kernels' plain versions), dropout 0, 2 steps of 2 windows a rank."""
    n = dist.get_world_size()
    cfg = InformerConfig(seq_len=16, label_len=4, pred_len=2, d_model=16, n_heads=2,
                         e_layers=(1,), d_layers=1, d_ff=16, distil=False, dropout=0.0,
                         use_pallas=True)
    h = torch.randn(4 * n, 22, 16, generator=torch.Generator().manual_seed(0))
    return {"losses": _chunk_dp_run(cfg, h, per_device_batch=2, num_steps=2, chunks=1,
                                      lr=1e-4)}


@case
def beam_sweep(inputs, initialized):
    """The antenna-sharded beam sweep on a model=P mesh."""
    from channelestimationtransformer_torch.channel.beamforming import (
        beam_sweep_project_sharded,
        dft_codebook_ri,
    )

    h = inputs["sweep_h"]
    m = make_mesh(data=1, model=dist.get_world_size())
    h_eff, selected = beam_sweep_project_sharded(h, dft_codebook_ri(h.shape[3], device="cpu"),
                                                 4, m)
    assert _replicated(h_eff) and _replicated(selected)
    return {"h_eff": h_eff, "selected": selected}


@case
def sharded_dataset(inputs, initialized):
    """This rank's shard of the sample-sharded dataset on a data=P mesh, and
    the refusal of a sample count the axis does not divide."""
    from channelestimationtransformer_torch.channel.cdl import CDLModel
    from channelestimationtransformer_torch.channel.dataset import (
        generate_beamformed_dataset_sharded,
    )

    m = make_mesh()
    kwargs = dict(model=CDLModel(num_bs_ant=16), num_slots=10, device="cpu")
    shard = generate_beamformed_dataset_sharded((5, 1), m, num_samples=2 * m.size(), **kwargs)
    try:
        generate_beamformed_dataset_sharded(0, m, num_samples=2 * m.size() + 1, **kwargs)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("an indivisible sample count was accepted")
    return {"shard": shard, "refused": refused}


@case
def trainer_resume(inputs, initialized):
    """``Trainer(mesh=...)``: a run stopped after epoch 2 and resumed from
    its checkpoint ends bit-identical to an uninterrupted one; validation
    gives a single process's ``eval_chunk``; an indivisible batch raises."""
    import tempfile

    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )
    from channelestimationtransformer_torch.train.trainer import Trainer, eval_chunk

    m = make_mesh()
    cfg = InformerConfig(seq_len=12, label_len=4, pred_len=2, d_model=16, n_heads=2,
                         e_layers=(2,), d_layers=1, d_ff=16, dropout=0.1)
    h = torch.randn(16, 20, 16, generator=torch.Generator().manual_seed(1))
    data = [WindowDataset(h=x, seq_len=12, pred_len=2, snr_db=20.0, device="cpu")
            for x in (h[:12], h[12:])]

    def trainer(**kw):
        tc = TrainConfig(batch_size=4, num_epochs=3, steps_per_epoch=3, log_every=3, **kw)
        return Trainer(build_informer(cfg, device="cpu", seed=0), cfg, tc, *data, mesh=m,
                       log=lambda msg: None)

    folder = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(folder)
    hist_a = (a := trainer()).fit()
    trainer(checkpoint_every_epochs=2, checkpoint_dir=folder[0]).fit(num_epochs=2)
    c = trainer()
    c.state, epoch, _ = load_checkpoint(latest_checkpoint(folder[0], "tmodel_"), c.state)
    assert epoch == 2 and c.state.step == 6
    hist_c = c.fit(start_epoch=2)
    sa, sc = a.model.state_dict(), c.model.state_dict()
    assert all(torch.equal(sa[k], sc[k]) for k in sa)
    assert hist_a[-1]["nmse"] == hist_c[-1]["nmse"]
    assert _replicated(_flat_params(a.model))
    single = eval_chunk(a.model, data[1], num_batches=8, batch_size=4, label_len=4,
                        generator=stream_generator("cpu", 1, 2, 1 << 20))
    assert float(single["nmse"]) == hist_a[-1]["nmse"]
    try:
        Trainer(build_informer(cfg, device="cpu"), cfg, TrainConfig(batch_size=3), *data,
                mesh=m)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("batch 3 on 2 ranks was accepted")
    return {"nmse": hist_a[-1]["nmse"], "refused": refused}


# --- two axes, every model under tensor parallelism, resuming, the dry run --------------


def _sgd_state(model):
    from channelestimationtransformer_torch.train.trainer import TrainState

    return TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=1.0),
                      schedule=lambda count: 1.0)


def _mesh_step(cfg, state_dict, batch, mesh, *, ring=False):
    """One ``_update`` (SGD at lr 1) over ``mesh``: global rank 0's weights,
    the parameters sharded over its model axis, this rank's ``data`` part of
    the global ``batch`` (a ring model built over the mesh when ``ring``).
    Returns the model, the step's metrics and the gathered state dict."""
    from channelestimationtransformer_torch.parallel.tensor import (
        full_state_dicts,
        replicated_grads_equal,
        tensor_parallel,
    )
    from channelestimationtransformer_torch.train.trainer import _update

    model = build_informer(cfg, device="cpu", mesh=mesh if ring else None)
    model.load_state_dict(state_dict)
    tensor_parallel(model, mesh)
    group = mesh.get_group("data")
    d, per = dist.get_rank(group), batch[0].shape[0] // dist.get_world_size(group)
    metrics = _update(_sgd_state(model), *(t[d * per:(d + 1) * per] for t in batch),
                      torch.Generator().manual_seed(0), group)
    assert replicated_grads_equal(model)
    return model, metrics, full_state_dicts(model)[0]


@case
def dp_tp_update(inputs, initialized):
    """One ``_update`` on a data 2 x model 2 mesh: each rank its data
    coordinate's half of the global batch of the small stack (distil on),
    its rows of the sharded weights; the loss and the gathered state after
    the step, the same on every rank."""
    mesh = make_mesh(data=2, model=2)
    _, metrics, state = _mesh_step(InformerConfig(**inputs["tp_cfg"]), inputs["tp_state_False"],
                                   inputs["tp2d_batch"], mesh)
    assert _replicated(torch.cat([t.reshape(-1).float() for t in state.values()]))
    return {"loss": float(metrics["loss"]), "state": state}


@case
def seq_axes(inputs, initialized):
    """The ring Informer (distil off) on model 2 x seq 2 and on data 2 x
    seq 2 against the full model's replicated step on the global batch: the
    loss and every parameter after the step (SGD at lr 1)."""
    batch = inputs["ring_batch"]
    full, m_full = _sgd_step(InformerConfig(**inputs["ring_cfg"]), inputs["ring_state"], batch)
    full = full.state_dict()
    out = {}
    for axes in (dict(data=1, model=2, seq=2), dict(data=2, model=1, seq=2)):
        ring_cfg = InformerConfig(**inputs["ring_cfg"], attn="ring")
        _, metrics, state = _mesh_step(ring_cfg, inputs["ring_state"], batch, make_mesh(**axes),
                                       ring=True)
        assert torch.allclose(metrics["loss"], m_full["loss"], rtol=2e-4), (axes, metrics)
        _params_close(state, full)
        out["x".join(str(v) for v in axes.values())] = {"loss": float(metrics["loss"]),
                                                        "state": state}
    return out


def _tp_trainer(cfg, tc, data, mesh, **kw):
    from channelestimationtransformer_torch.train.trainer import Trainer

    return Trainer(build_informer(cfg, device="cpu", seed=0), cfg, tc, *data, mesh=mesh,
                   log=lambda msg: None, **kw)


@case
def trainer_2d_resume(inputs, initialized):
    """``Trainer`` on a data 2 x model 2 mesh, dropout 0.1: two epochs
    against one epoch, its gathered checkpoint, ``load_checkpoint`` into a
    new tensor-parallel Trainer and ``fit(start_epoch=1)``: the histories
    and the parameters bit for bit. Then ``cli/train_informer.py`` on the
    mesh: two epochs against one and ``--resume``, bit for bit."""
    import tempfile

    from channelestimationtransformer_torch.cli import train_informer
    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    mesh = make_mesh(data=2, model=2)
    cfg = InformerConfig(**dict(inputs["tp_cfg"], dropout=0.1))
    h = torch.randn(8, 40, 16, generator=torch.Generator().manual_seed(3))
    data = [WindowDataset(h=x, seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=20.0,
                          device="cpu") for x in (h[:6].repeat(2, 1, 1), h[6:])]
    folder = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(folder)
    tc = TrainConfig(batch_size=4, num_epochs=2, steps_per_epoch=2, log_every=2,
                     checkpoint_every_epochs=1, checkpoint_dir=folder[0])
    whole = _tp_trainer(cfg, dataclasses.replace(tc, checkpoint_every_epochs=0), data, mesh)
    hist_whole = whole.fit()
    _tp_trainer(cfg, tc, data, mesh).fit(num_epochs=1)
    resumed = _tp_trainer(cfg, tc, data, mesh)
    resumed.state, epoch, _ = load_checkpoint(latest_checkpoint(folder[0], "tmodel_"),
                                              resumed.state)
    assert epoch == 1 and resumed.state.step == 2
    hist_resumed = resumed.fit(start_epoch=1)
    assert [e["nmse"] for e in hist_whole[1:]] == [e["nmse"] for e in hist_resumed]
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for p, q in zip(whole.state.optimizer.state.values(), resumed.state.optimizer.state.values()):
        assert all(torch.equal(p[k], q[k]) for k in p)

    argv = ["--device", "cpu", "--d-model", "32", "--n-heads", "4", "--d-ff", "32",
            "--e-layers", "2", "1", "--d-layers", "1", "--seq-len", "24", "--label-len", "6",
            "--batch-size", "4", "--steps-per-epoch", "2", "--log-every", "2",
            "--train-samples", "16", "--val-samples", "8", "--num-slots", "40",
            "--checkpoint-every", "1"]
    runs = {}
    for name, steps in (("whole", [["--epochs", "2"]]),
                        ("resumed", [["--epochs", "1"], ["--epochs", "2", "--resume"]])):
        for extra in steps:
            runs[name] = train_informer.main(argv + extra + ["--out", f"{folder[0]}/{name}"],
                                             mesh=mesh)
    assert runs["whole"]["history_nmse"][1:] == runs["resumed"]["history_nmse"]
    return {"nmse": [e["nmse"] for e in hist_whole], "cli": runs["whole"]["history_nmse"]}


@case
def tp_lsq(inputs, initialized):
    """The small LSQ-fibbinary stack (use_pallas: the wrappers' plain
    versions here) at model 2 against the replicated model: one ``_update``
    (SGD at lr 1), each shard's gradient its rows of the replicated one,
    every ``step_size`` gradient summed over the group, the replicated
    gradients equal on both ranks bit for bit; ``reset_step_size`` on the
    shards gives the replicated value. Returns the loss and every gradient,
    gathered."""
    from channelestimationtransformer_torch.models.informer_lsq import build_informer_lsq
    from channelestimationtransformer_torch.ops.quant import DenseLSQ
    from channelestimationtransformer_torch.parallel.tensor import (
        gather_rows,
        replicated_grads_equal,
        sharded_names,
        tensor_parallel,
    )
    from channelestimationtransformer_torch.train.trainer import _update

    cfg = InformerConfig(**inputs["lsq_cfg"], use_pallas=True)
    models = {}
    for path in ("tp", "replicated"):
        model = build_informer_lsq(cfg, nbits=8, fibbinary=True, device="cpu")
        model.load_state_dict(inputs["lsq_state"])
        if path == "tp":
            tensor_parallel(model, _tp_mesh())
        metrics = _update(_sgd_grads(model), *inputs["lsq_batch"],
                          torch.Generator().manual_seed(0))
        models[path] = (model, float(metrics["loss"]))
    tp, rep = models["tp"][0], models["replicated"][0]
    assert replicated_grads_equal(tp)
    sharded = sharded_names(tp)
    layers = {n: m for n, m in tp.named_modules() if isinstance(m, DenseLSQ)}
    assert len(layers) == 28 and all(m.tp_group is not None for m in layers.values())
    group = next(iter(layers.values())).tp_group
    grads = {}
    for (name, p), q in zip(tp.named_parameters(), rep.parameters()):
        g = gather_rows(p.grad, group) if name in sharded else p.grad
        assert torch.allclose(g, q.grad, rtol=2e-4, atol=2e-5), name
        grads[name] = g
    replicated = dict(rep.named_modules())
    for name, m in layers.items():
        m.reset_step_size()  # from the whole weight, gathered
        replicated[name].reset_step_size()
        assert torch.equal(m.step_size, replicated[name].step_size), name
    return {"loss": models["tp"][1], "grads": grads}


@case
def train_lsq_tp(inputs, initialized):
    """``cli/train_lsq.py`` (shrunken widths, random windows, one step) on a
    model axis of 2 against the same run on a mesh of the same draws with
    nothing sharded:
    each rank overlays its rows of the gathered FP32 checkpoint; the
    result and the checkpoint (gathered, written by rank 0) agree."""
    import functools
    import json
    import tempfile

    from channelestimationtransformer_torch.cli import train_lsq
    from channelestimationtransformer_torch.train.checkpoint import save_checkpoint
    from channelestimationtransformer_torch.train.trainer import create_train_state

    from channelestimationtransformer_torch.data.windows import WindowDataset

    def windows(key, *, num_samples, num_slots, seq_len, pred_len, snr_db, device, model):
        """Random windows in place of the CDL data (the ranks draw alike)."""
        h = torch.randn(min(num_samples, 64), num_slots, 16,
                        generator=torch.Generator().manual_seed(key))
        return WindowDataset(h=h, seq_len=seq_len, pred_len=pred_len, snr_db=snr_db,
                             device=device)

    cfg = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, d_ff=16)
    train_lsq.InformerConfig = functools.partial(InformerConfig, **cfg)
    train_lsq.make_window_dataset = windows
    folder = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(folder)
    if dist.get_rank() == 0:
        fp32 = build_informer(InformerConfig(**cfg), device="cpu", seed=1)
        save_checkpoint(create_train_state(fp32, TrainConfig()), folder[0], "fp32_", 1)
    dist.barrier()
    argv = ["--device", "cpu", "--fibbinary", "--nbits-min", "8", "--nbits-max", "8",
            "--epochs", "1", "--steps-per-epoch", "1", "--train-samples", "64", "--calibrated",
            "--checkpoint", f"{folder[0]}/fp32_1.pt"]
    runs = {}
    for name, mesh in (("tp", _tp_mesh()),
                       ("replicated", make_mesh(data=1, model=1, seq=dist.get_world_size()))):
        runs[name] = train_lsq.main(argv + ["--out", f"{folder[0]}/{name}"], mesh=mesh)
    a, b = (runs[k]["lsqfib_n8"]["final_val_nmse"] for k in ("tp", "replicated"))
    assert _close_lists([a], [b]), (a, b)
    if dist.get_rank() == 0:
        saved = {k: torch.load(f"{folder[0]}/{k}/lsqfib_n8_1.pt", weights_only=True)["model"]
                 for k in runs}
        _trained_close(saved["tp"], saved["replicated"],
                       TrainConfig(lr=1e-4, num_epochs=1, steps_per_epoch=1))
        on_disk = json.loads(open(f"{folder[0]}/tp/lsq_fibbinary_results.json").read())
        assert on_disk["lsqfib_n8"] == runs["tp"]["lsqfib_n8"]
    return {"nmse": a}


def _sgd_grads(model):
    """A state whose optimizer leaves the parameters as they are (lr 0)."""
    from channelestimationtransformer_torch.train.trainer import TrainState

    return TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.0),
                      schedule=lambda count: 0.0)


@case
def tp_baselines(inputs, initialized):
    """The Transformer, the LSTM, GRU and RNN predictors (flax's weights
    from the inputs) and a quantized ``ConvLSQ`` (k 3, fibbinary) at model
    2 against the replicated model with the same weights: the forward
    (eval; the recurrent ones' rollout too), then one SGD step at lr 1 on
    an NMSE loss (dropout 0): the loss, each shard against its rows of the
    replicated parameters, the replicated gradients equal on both ranks bit
    for bit. Returns each model's eval output (and rollout), loss and
    gradients, gathered, for the JAX side."""
    from channelestimationtransformer_torch.core.config import RecurrentConfig, TransformerConfig
    from channelestimationtransformer_torch.core.metrics import nmse
    from channelestimationtransformer_torch.models import build_recurrent, build_transformer
    from channelestimationtransformer_torch.parallel.tensor import (
        full_state_dicts,
        gather_rows,
        replicated_grads_equal,
        sharded_names,
        tensor_parallel,
    )

    x = inputs["baselines"]["x"]
    cfgs, states = inputs["baselines"]["cfgs"], inputs["baselines"]["states"]

    def loaded(model, name):
        model.load_state_dict(states[name])
        return model

    builders = {
        "transformer": (lambda: loaded(build_transformer(TransformerConfig(
            **cfgs["transformer"]), device="cpu"), "transformer"),
            lambda m: m(x["x_enc"], x["x_dec"]), lambda out: nmse(out, x["target"])),
        **{cell: (lambda cell=cell: loaded(build_recurrent(RecurrentConfig(
            **cfgs["recurrent"], cell=cell), device="cpu"), cell),
            lambda m: m(x["seq"]), lambda out: nmse(out[:, 1:], x["seq"][:, 1:]))
           for cell in ("lstm", "gru", "rnn")},
        "conv_lsq": (_conv_lsq, lambda m: m(x["seq"]), lambda out: nmse(out, x["seq"])),
    }
    out = {}
    for name, (build, forward, loss_fn) in builders.items():
        rep, tp = build(), build()
        mesh = _tp_mesh()
        tensor_parallel(tp, mesh)
        sharded = sharded_names(tp)
        assert sharded, name
        got = {}
        with torch.no_grad():
            got["out"] = forward(tp)
            assert torch.allclose(got["out"], forward(rep), rtol=2e-4, atol=2e-5), name
            if hasattr(rep, "rollout"):
                got["rollout"] = tp.rollout(x["seq"], 4)
                assert torch.allclose(got["rollout"], rep.rollout(x["seq"], 4), rtol=2e-4,
                                      atol=2e-5), name
        losses = []
        for m in (tp, rep):
            m.train()
            state = _sgd_state(m)
            loss = loss_fn(forward(m))
            loss.backward()
            if m is tp:
                got["grads"] = {n: gather_rows(p.grad, mesh.get_group("model"))
                                if n in sharded else p.grad.clone()
                                for n, p in tp.named_parameters()}
            state.optimizer.step()
            losses.append(float(loss))
        assert abs(losses[0] - losses[1]) <= 2e-4 * abs(losses[1]), (name, losses)
        assert replicated_grads_equal(tp), name
        _params_close(full_state_dicts(tp)[0], rep.state_dict())
        out[name] = dict(got, loss=losses[0], sharded=sorted(sharded))
    return out


def _conv_lsq():
    """A ConvLSQ (16 -> 16 channels, k 3, 6 bits, fibbinary) with seeded weights."""
    from channelestimationtransformer_torch.ops.quant import ConvLSQ

    m = ConvLSQ(16, 16, 3, nbits=6, quantize=True, fibbinary=True, use_pallas=True)
    m.reset_parameters(torch.Generator().manual_seed(3))
    return m


@case
def multichip(inputs, initialized):
    """``cli/multichip.py`` on every rank: its three legs with the JAX dry
    run's weights and draws (dropout 0 in the training step), and the dry
    run itself with its own."""
    from channelestimationtransformer_torch.cli import multichip as mc

    n = dist.get_world_size()
    train = mc.train_leg(n, "cpu", state_dict=inputs["mc_train_state"],
                         draws=inputs["mc_draws"], dropout=0.0)
    ring = mc.ring_leg(n, "cpu", state_dict=inputs["mc_ring_state"])
    pipe = mc.pipeline_leg(n, "cpu", train["mesh"], h=inputs["mc_h"])
    return {"train": {k: train[k] for k in ("loss", "state", "grads")},
            "ring": ring, "pipeline": pipe, "dryrun": mc.dryrun_multichip(n, "cpu")}


def spawn(folder, cases, nprocs, inputs=None, timeout=300.0):
    """Run ``cases`` on ``nprocs`` gloo ranks of this file (one thread
    each, joined within ``timeout`` seconds) and return each rank's outputs."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    if inputs is not None:
        torch.save(inputs, folder / "inputs.pt")
    launch.run_local([sys.executable, __file__, str(folder), *cases], nprocs, timeout=timeout,
                     threads=1)
    return [torch.load(folder / f"out_{r}.pt", weights_only=True) for r in range(nprocs)]


def main(folder, names):
    torch.set_num_threads(1)
    initialized = launch.initialize_distributed(device="cpu")
    if not initialized:
        launch.join_local(device="cpu")  # a world of one
    path = Path(folder) / "inputs.pt"
    inputs = torch.load(path, weights_only=True) if path.exists() else {}
    out = {name: CASES[name](inputs, initialized) for name in names}
    rank = dist.get_rank()
    torch.save(out, Path(folder) / f"out_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
