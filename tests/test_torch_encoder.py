"""The port's embedding-free, non-causal encoder (hubert-xlarge: inputs are
(B, S, D) frame embeddings from a stub front end, `causal=False`, no
`embed` leaf, no decode) against the reference, on the CPU; and the entry
points that cannot run an arch for want of its input.

The reference's weights (`init_params`, PRNGKey(0)) go into the port
through `params_from_jax`; the same frame embeddings (numpy, from a seed,
rounded to bf16 by both `forward`s) go through both. At the SMOKE head
dim (16) both attend blockwise, not causal; at full width (head dim 80)
too, as the reference routes 80 to jnp. Tolerances:

- logits in train mode (the reference's `encode` cell) and prefill mode:
  5e-2 of max |logit|, the bound `tests/test_torch_model.py` holds the
  dense SMOKE models to;
- a sequence encoded alone against its row of a batch: 5e-2 of max
  |logit| (the same arithmetic per row; bf16 matmuls may block otherwise
  at another batch size);
- loss and every parameter gradient of `loss_fn` in bf16, leaf by leaf:
  loss 1e-3 relative, each leaf within 2e-2 of its max |grad| beyond the
  reference's own bf16 error on it, as `tests/test_torch_train.py` holds
  the other configs. The reference cannot run hubert with fp32 leaves
  (its scan carries the bf16 input embeddings into fp32 blocks and
  rejects the dtype change), so the port's fp32 gradient stands for the
  exact one in that error;
- trees and checkpoints: byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefManager
from repro.ckpt.store import BlockStore as RefStore
from repro.configs import get_config as ref_get_config
from repro.core import make_unilrc as ref_make_unilrc
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models.model import abstract_params as ref_abstract_params
from repro.train import TrainConfig as RefTrainConfig
from repro.train import loss_fn as ref_loss_fn
from repro.topo import Topology as RefTopology
from repro_torch.ckpt import BlockStore, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import make_unilrc
from repro_torch.io import TorchBackend
from repro_torch.kernels import flash_attention as fak
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import (abstract_params, forward, init_params,
                                layers, params_from_jax, params_to_tree)
from repro_torch.models.model import tree_of
from repro_torch.topo import Topology
from repro_torch.train import loss_fn

ARCH = "hubert-xlarge"
TOL = 5e-2


def _host(tree):
    """A reference tree as numpy, bf16 leaves as uint16 bit views."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                   else np.asarray(a)), tree)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _rel(want, got) -> float:
    want = np.array(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = params_from_jax(cfg, _host(params), "cpu")
    frames = np.random.default_rng(0).normal(
        size=(3, 24, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, params, model, frames


def test_encode_matches_the_reference(smoke):
    """Train mode (the reference's `encode` kind) and prefill mode on fp32
    frame embeddings, which both packages round to bf16: one blockwise,
    non-causal call per layer; prefill caches each layer's k and v."""
    ref_cfg, cfg, params, model, frames = smoke
    assert not cfg.embed_inputs and not cfg.causal and not cfg.has_decode
    fak.reset_counts()
    layers.reset_blockwise_calls()
    for mode in ("train", "prefill"):
        want, rc, _ = ref_forward(params, jnp.asarray(frames), ref_cfg,
                                  mode=mode)
        got, cache, _ = forward(model, torch.from_numpy(frames), mode=mode)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _rel(want, got) < TOL
        if mode == "prefill":
            assert [tuple(b.shape) for b in
                    jax.tree_util.tree_leaves(cache)] == \
                [a.shape for a in jax.tree_util.tree_leaves(rc)]
    assert (fak.launches, fak.plain_calls, layers.blockwise_calls) == \
        (0, 0, 2 * cfg.num_layers)
    # bf16 frames are taken as they are
    bf16 = torch.from_numpy(frames).bfloat16()
    a, _, _ = forward(model, bf16, mode="train")
    b, _, _ = forward(model, torch.from_numpy(frames), mode="train")
    assert torch.equal(a, b)


def test_encoder_is_not_causal_and_rows_are_independent(smoke):
    """A later frame changes every position's logits (no causal mask), in
    both packages; each sequence encoded alone is its row of the batch."""
    ref_cfg, _, params, model, frames = smoke
    later = frames.copy()
    later[:, -1] += 1.0
    for run in (lambda x: np.array(jnp.asarray(ref_forward(
                    params, jnp.asarray(x), ref_cfg)[0], jnp.float32)),
                lambda x: forward(model, torch.from_numpy(x))[0]
                .float().numpy()):
        a, b = run(frames), run(later)
        assert (np.abs(a[:, 0] - b[:, 0]).max(-1) > 0).all()
    batch, _, _ = forward(model, torch.from_numpy(frames), mode="train")
    for i in range(frames.shape[0]):
        alone, _, _ = forward(model, torch.from_numpy(frames[i:i + 1]),
                              mode="train")
        want = batch[i:i + 1].float()
        assert ((alone.float() - want).abs().max() / want.abs().max()) < TOL


def test_remat_encode_gives_the_same_grads(smoke):
    """Training without an embedding table: remat="block" recomputes each
    layer from its embedding-free input and gives the same gradients."""
    _, cfg, params, _, frames = smoke
    grads = []
    for remat in ("none", "block"):
        model = params_from_jax(cfg, _host(params), "cpu")
        model.requires_grad_(True)
        logits, _, _ = forward(model, torch.from_numpy(frames), remat=remat)
        logits.float().square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_grads_match_the_reference_in_bf16(smoke):
    ref_cfg, cfg, params, _, frames = smoke
    labels = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 24))
    (loss, _), want = jax.value_and_grad(ref_loss_fn, has_aux=True)(
        params, jnp.asarray(frames), jnp.asarray(labels), ref_cfg,
        RefTrainConfig())
    got = {}
    for prec in ("bf16", "fp32"):
        model = params_from_jax(cfg, _host(params), "cpu")
        if prec == "fp32":
            model.float()
        model.requires_grad_(True)
        value, _ = loss_fn(model, torch.from_numpy(frames),
                           torch.from_numpy(labels))
        value.backward()
        got[prec] = (float(value.detach()), jax.tree_util.tree_leaves_with_path(
            tree_of(model, lambda p: p.grad)))
    assert abs(got["bf16"][0] - float(loss)) <= 1e-3 * float(loss)
    want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in want] == [p for p, _ in got["bf16"][1]]
    for (path, a), (_, b16), (_, b32) in zip(want, got["bf16"][1],
                                              got["fp32"][1]):
        a = np.array(jnp.asarray(a, jnp.float32))
        scale = np.abs(a).max()
        noise = float(np.abs(b32.numpy() - a).max() / scale)
        err = float(np.abs(b16.float().numpy() - a).max() / scale)
        assert b16.dtype == torch.bfloat16
        assert err < 2e-2 + noise, (jax.tree_util.keystr(path), err, noise)


def test_tree_has_no_embed_and_checkpoints_across_packages(smoke):
    _, _, params, model, _ = smoke
    assert "embed" not in params and not hasattr(model, "embed")
    want = jax.tree_util.tree_leaves_with_path(_host(params))
    saved = params_to_tree(model)
    assert set(saved) == {"segments", "final_norm", "unembed"}
    got = jax.tree_util.tree_leaves_with_path(saved)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert np.array_equal(a, _bits(b)), path
    ref = RefManager(RefStore(RefTopology(4, 8)), ref_make_unilrc(1, 4),
                     block_size=4096, backend="numpy")
    mgr = CheckpointManager(BlockStore(Topology(4, 8)), make_unilrc(1, 4),
                            block_size=4096, backend=TorchBackend("cpu"))
    assert mgr.save(saved, step=4) == ref.save(_host(params), step=4)
    for key, data in ref.store._blocks.items():
        assert bytes(mgr.store._blocks[key]) == bytes(data), key
    node = mgr.store.node_of(0, 0)
    mgr.store.fail_node(node)
    ref.store.fail_node(node)
    back, report = mgr.restore()
    assert report.degraded_blocks > 0 and report.cross_cluster_bytes == 0
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back), strict=True):
        assert np.array_equal(_bits(a), _bits(b))
    model2 = params_from_jax(get_config(ARCH, smoke=True), back, "cpu")
    for p, q in zip(model.parameters(), model2.parameters(), strict=True):
        assert torch.equal(p, q)


def test_init_params_draws_no_embedding():
    cfg = get_config(ARCH, smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    names = {n for n, _ in model.named_parameters()}
    assert "embed" not in names and "unembed" in names
    out, _, _ = forward(model, torch.randn(2, 8, cfg.d_model))
    assert out.shape == (2, 8, cfg.vocab_size)


def test_full_width_hubert_matches_the_reference_layout():
    """hubert-xlarge at full width on the meta device: 48 layers, 16 heads
    of 80, no embedding, the reference's leaves, shapes and dtypes.
    `param_count()` counts an embedding the model does not have."""
    cfg = get_config(ARCH)
    ref = jax.tree_util.tree_leaves_with_path(
        ref_abstract_params(ref_get_config(ARCH)))
    got = jax.tree_util.tree_leaves_with_path(abstract_params(cfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in ref] == [
        (jax.tree_util.keystr(p), tuple(b.shape),
         str(b.dtype).replace("torch.", "")) for p, b in got]
    assert sum(b.numel() for _, b in got) == 1_259_060_480
    assert sum(b.numel() * b.element_size() for _, b in got) == \
        2_518_120_960
    assert cfg.param_count() - 1_259_060_480 == \
        cfg.vocab_size * cfg.d_model - cfg.d_model
    assert (cfg.num_heads_padded, cfg.resolved_head_dim) == (16, 80)


def test_serve_exits_for_the_encoder():
    """The reference's server exits for an encoder-only arch; so does the
    port's."""
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.run(["--arch", ARCH, "--device", "cpu"])


@pytest.mark.parametrize("arch,names", [
    (ARCH, "frame embeddings"),
    ("llama-3.2-vision-11b", "vision input"),
])
def test_train_cli_exits_naming_the_missing_input(arch, names, capsys):
    """The token pipeline gives neither hubert's frame embeddings nor the
    vision model's image input: the training entry point exits naming it
    before it builds anything (the reference's fails inside its step)."""
    with pytest.raises(SystemExit, match=names):
        train_cli.run(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "1"])
    assert "arch=" not in capsys.readouterr().out
    assert train_cli.input_missing(get_config("llama3.2-3b")) is None
