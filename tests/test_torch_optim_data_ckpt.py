"""The port's optimizer, data pipeline and checkpoints, on the CPU: the
twins of ``tests/test_optim_data_ckpt.py`` case by case, and against the
reference:

* ``adamw_update`` on identical inputs (the reference's gradients fed to
  both): parameters and float32 moments within 1e-6 relative, bf16
  moments within one bf16 ulp; clipped and unclipped; ``cosine_schedule``
  within 1e-6;
* ``TokenPipeline`` batches bit-identical to the reference's for three
  seeds (and the modality extras);
* the checkpoint bytes equal to the reference's ``save_checkpoint``'s on
  the same tree (float32, bf16, int and 0-d leaves, an ``AdamWState``),
  loads across the packages in both directions, and the port's msgpack
  decoder against ``msgpack.unpackb`` (the reference's dependency, used
  here only).
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as jload
from repro.ckpt import save_checkpoint as jsave
from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.optim import adamw_init as jinit
from repro.optim import adamw_update as jupdate
from repro.optim import cosine_schedule as jcosine
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import unpackb
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import TokenPipeline, make_batch_specs
from repro_torch.models.model import params_from_jax
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import flatten, tree_map, unflatten

ADAMW_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the smoke models are tiny, and under the
    suite's parallel workers torch's default of a thread per core in every
    worker oversubscribes the machine (bf16 steps ran 40x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def as_f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


class TestAdamW:
    def test_converges_on_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = adamw_init(params)
        for _ in range(300):
            grads = {"w": 2 * params["w"]}
            params, state = adamw_update(params, grads, state, lr=0.05, weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.1

    def test_grad_clip(self):
        params = {"w": torch.zeros(3)}
        state = adamw_init(params)
        huge = {"w": torch.full((3,), 1e9)}
        p2, _ = adamw_update(params, huge, state, lr=0.1, grad_clip=1.0)
        assert torch.isfinite(p2["w"]).all()

    def test_bf16_moments(self):
        params = {"w": torch.zeros((4,), dtype=torch.bfloat16)}
        state = adamw_init(params, moment_dtype="bfloat16")
        assert state.m["w"].dtype == torch.bfloat16

    def test_cosine_schedule(self):
        sched = cosine_schedule(1.0, warmup_steps=10, total_steps=100)
        assert float(sched(0)) == 0.0
        assert float(sched(torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0)
        assert float(sched(100)) == pytest.approx(0.0, abs=1e-6)

    def test_cosine_schedule_matches_the_reference(self):
        j, t = jcosine(3e-4, 7, 50), cosine_schedule(3e-4, 7, 50)
        for s in (0, 1, 6, 7, 8, 25, 49, 50, 80):
            np.testing.assert_allclose(float(t(s)), float(j(jnp.int32(s))), rtol=1e-6)

    @pytest.mark.parametrize("moments", ["float32", "bfloat16"])
    @pytest.mark.parametrize("clip, grad_scale, rows", [
        (0.0, 1.0, 300),   # no clip
        (1.0, 1e-3, 300),  # the clip on, the norm below it: scale exactly 1
        (1.0, 1.0, 4),     # the clip at work on a small tree
    ], ids=["no-clip", "clip-idle", "clip-active"])
    def test_update_matches_the_reference(self, moments, clip, grad_scale, rows):
        """A tree of bf16 and float32 leaves (``big`` split into row blocks),
        four steps from the same state with the same gradients. Where the
        clip scales the gradients, the global norm is a float32 sum in each
        package's order (XLA's and torch's): over the 19,200 elements of a
        300-row ``big`` leaf the two orders move the scale by up to 4e-6
        relative, so the clip is held at work on a tree small enough for
        both sums to agree to float32's rounding. Even there the scale's
        last bit moves elements of ``m`` that four steps of gradients of
        both signs nearly cancel (5.7e-5 relative on one of 2.3e-5), so the
        float32 leaves of that case are held to 1e-6 x their largest value;
        the other cases element by element."""
        rng = np.random.default_rng(4)
        shapes = {"big": ((rows, 64), jnp.bfloat16), "norm": ((64,), jnp.float32),
                  "stack": [((3, 8, 5), jnp.bfloat16), ((2,), jnp.float32)]}
        params = jax.tree_util.tree_map(
            lambda s: jnp.asarray(rng.standard_normal(s[0]), s[1]), shapes,
            is_leaf=lambda s: isinstance(s, tuple))
        j_state = jinit(params, moments)
        t_params, t_state = to_torch(params), adamw_init(to_torch(params), moments)
        from repro_torch.optim import adamw as tadamw

        old_chunk = tadamw.CHUNK
        tadamw.CHUNK = 64 * 16  # "big" runs in 16-row blocks
        try:
            for step in range(4):
                grads = jax.tree_util.tree_map(
                    lambda p: jnp.asarray(rng.standard_normal(p.shape) * grad_scale * (step + 1),
                                          p.dtype),
                    params)
                params, j_state = jupdate(params, grads, j_state, 1e-2, grad_clip=clip)
                t_params, t_state = adamw_update(t_params, to_torch(grads), t_state, 1e-2,
                                                 grad_clip=clip)
        finally:
            tadamw.CHUNK = old_chunk
        assert int(t_state.step) == int(j_state.step) == 4
        for want, got in ((params, t_params), (j_state.m, t_state.m), (j_state.v, t_state.v)):
            for w, g in zip(jax.tree_util.tree_leaves(want), flatten(got)[0]):
                assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
                if g.dtype == torch.bfloat16:  # within one bf16 ulp of the reference's value
                    ulp = 2.0 ** (np.floor(np.log2(np.abs(as_f32(w)) + 1e-38)) - 7)
                    assert (np.abs(as_f32(g) - as_f32(w)) <= ulp).all()
                elif clip and grad_scale == 1.0:
                    assert np.abs(as_f32(g) - as_f32(w)).max() <= ADAMW_RTOL * np.abs(
                        as_f32(w)).max()
                else:
                    np.testing.assert_allclose(as_f32(g), as_f32(w), rtol=ADAMW_RTOL, atol=0)

    def test_update_writes_in_place_and_checks_structure(self):
        params = {"a": torch.ones(3), "b": torch.ones(2)}
        state = adamw_init(params)
        ptr = params["a"].data_ptr()
        new, new_state = adamw_update(params, {"a": torch.ones(3), "b": torch.ones(2)}, state, 0.1)
        assert new["a"].data_ptr() == ptr and new_state.m["a"] is state.m["a"]
        assert int(new_state.step) == 1 and int(state.step) == 0
        with pytest.raises(ValueError, match="structure"):
            adamw_update(params, {"a": torch.ones(3)}, state, 0.1)


class TestPipeline:
    def test_deterministic(self):
        cfg = get_smoke_config("qwen3-8b")
        a = TokenPipeline(cfg, 2, 16, seed=5).next_batch()
        b = TokenPipeline(cfg, 2, 16, seed=5).next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    @pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-large-v3"])
    def test_modality_extras(self, arch):
        """The port's own smoke configs of the two."""
        cfg = get_smoke_config(arch)
        batch = TokenPipeline(cfg, 2, 16).next_batch()
        if cfg.frontend == "vision":
            assert batch["patches"].shape == (2, cfg.num_patches, 1024)
        else:
            assert batch["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)

    @pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-large-v3", "phi-3-vision-4.2b"])
    def test_specs_match_batches(self, arch):
        cfg = _port_smoke(arch)
        batch = TokenPipeline(cfg, 3, 8).next_batch()
        specs = make_batch_specs(cfg, 3, 8)
        assert set(specs) == set(batch)
        for k in specs:
            assert tuple(specs[k].shape) == batch[k].shape
            assert specs[k].device.type == "meta"
            assert str(specs[k].dtype).removeprefix("torch.") == str(batch[k].dtype)

    def test_tokens_learnable_structure(self):
        """Markov structure: bigram entropy below unigram entropy."""
        cfg = get_smoke_config("qwen3-8b")
        toks = TokenPipeline(cfg, 64, 128).next_batch()["tokens"]
        a, b = toks[:, :-1].ravel(), toks[:, 1:].ravel()
        uni_max = np.bincount(b).max() / len(b)
        tok0 = np.bincount(a).argmax()
        succ = b[a == tok0]
        cond_max = np.bincount(succ).max() / len(succ)
        assert cond_max > uni_max

    @pytest.mark.parametrize("seed", [0, 1, 17])
    @pytest.mark.parametrize("arch", ["deepseek-v3-671b", "gemma2-2b", "phi-3-vision-4.2b",
                                      "whisper-large-v3"])
    def test_batches_equal_the_reference(self, arch, seed):
        want_pipe = JPipeline(jsmoke(arch), 3, 20, seed=seed)
        got_pipe = TokenPipeline(_port_smoke(arch), 3, 20, seed=seed)
        for _ in range(3):
            want, got = want_pipe.next_batch(), got_pipe.next_batch()
            assert set(want) == set(got)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])

    def test_full_vocab_batches_equal_the_reference(self):
        """DeepSeek-V3's published config (vocabulary 129,280: the source
        draws from its first 4096 ids), the shape phase 14 trains on."""
        from repro.configs import get_config as jfull
        from repro_torch.configs import get_config as tfull

        want = JPipeline(jfull("deepseek-v3-671b"), 2, 64, seed=0).next_batch()
        got = TokenPipeline(tfull("deepseek-v3-671b"), 2, 64, seed=0).next_batch()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def _port_smoke(arch):
    import dataclasses

    from repro_torch.models import config as tconfig

    cfg = jsmoke(arch)

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        return v

    return tconfig.ModelConfig(**{f.name: conv(getattr(cfg, f.name))
                                  for f in dataclasses.fields(cfg)})


def _trees():
    """The same tree in both packages: float32, bf16, int32 and 0-d
    leaves, nested dicts out of key order and a list."""
    j = {
        "z": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "b": {"c": jnp.asarray(np.linspace(-3, 3, 40).reshape(5, 8), jnp.bfloat16),
              "d": jnp.int32(7), "a": jnp.float32(2.5)},
        "groups": [{"w": jnp.ones((2, 3, 4), jnp.bfloat16)}, {"w": jnp.zeros((0,), jnp.float32)}],
    }
    return j, to_torch(j)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {
            "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)},
        }
        path = os.path.join(tmp_path, "ckpt.msgpack")
        save_checkpoint(path, tree)
        out = load_checkpoint(path, tree)
        torch.testing.assert_close(out["a"], tree["a"], rtol=0, atol=0)
        assert out["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(out["b"]["c"], tree["b"]["c"])
        assert out["b"]["d"].dtype == torch.int32 and int(out["b"]["d"]) == 7
        assert not os.path.exists(path + ".tmp")

    def test_template_mismatch_raises(self, tmp_path):
        path = os.path.join(tmp_path, "ckpt.msgpack")
        save_checkpoint(path, {"a": torch.ones(3)})
        with pytest.raises(ValueError):
            load_checkpoint(path, {"a": torch.ones(3), "b": torch.ones(2)})

    def test_bytes_equal_the_reference(self, tmp_path):
        j, t = _trees()
        jsave(str(tmp_path / "j"), j)
        save_checkpoint(str(tmp_path / "t"), t)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()

    def test_adamw_state_bytes_equal_the_reference(self, tmp_path):
        j, t = _trees()
        j_state = jinit({"p": j["z"], "q": j["b"]["c"]}, "bfloat16")
        t_state = adamw_init({"p": t["z"], "q": t["b"]["c"]}, "bfloat16")
        assert isinstance(t_state, AdamWState)
        jsave(str(tmp_path / "j"), j_state)
        save_checkpoint(str(tmp_path / "t"), t_state)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
        loaded = load_checkpoint(str(tmp_path / "j"), t_state)
        assert isinstance(loaded, AdamWState) and loaded.step.dtype == torch.int32

    def test_loads_across_the_packages(self, tmp_path):
        j, t = _trees()
        jsave(str(tmp_path / "j"), j)
        got = load_checkpoint(str(tmp_path / "j"), t)
        for a, b in zip(flatten(got)[0], flatten(t)[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert list(got) == list(t) and list(got["b"]) == list(t["b"])
        save_checkpoint(str(tmp_path / "t"), t)
        back = jload(str(tmp_path / "t"), j)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(j)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))

    def test_model_checkpoint_bytes_equal_the_reference(self, tmp_path):
        """A whole smoke-config parameter tree (DeepSeek-V3: MLA, MoE, the
        MTP head, bf16)."""
        from repro.models import model as jmodel

        params = jmodel.init_params(jsmoke("deepseek-v3-671b"), jax.random.PRNGKey(0))
        jsave(str(tmp_path / "j"), params)
        save_checkpoint(str(tmp_path / "t"), to_torch(params))
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()

    def test_decoder_matches_msgpack(self, tmp_path):
        j, _ = _trees()
        jsave(str(tmp_path / "j"), j)
        raw = (tmp_path / "j").read_bytes()
        want = msgpack.unpackb(raw, raw=False)
        got = unpackb(raw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w) == ["dtype", "shape", "data"]
            assert g["dtype"] == w["dtype"] and g["shape"] == w["shape"]
            assert bytes(g["data"]) == w["data"]

    @pytest.mark.parametrize("obj", [
        [], list(range(15)), list(range(16)), list(range(70000)), {"k": 1},
        {f"k{i}": i for i in range(16)}, "s" * 31, "s" * 32, "s" * 300, "s" * 70000,
        b"", b"x" * 255, b"x" * 256, b"x" * 70000, 0, 127, 128, 255, 256, 65535, 65536,
        2**32 - 1, 2**32, 2**64 - 1, [{"dtype": "float32", "shape": [], "data": b"\0" * 4}],
    ], ids=lambda o: f"{type(o).__name__}{len(o) if hasattr(o, '__len__') else o}")
    def test_each_width_decodes_as_msgpack_packs_it(self, obj):
        """Every width msgpack picks for the format's types (fix, 8, 16, 32
        and 64 bits) decodes to the object packed."""
        got = unpackb(msgpack.packb(obj, use_bin_type=True))
        if isinstance(obj, bytes):
            got = bytes(got)
        assert got == obj or (isinstance(obj, list) and obj and isinstance(obj[0], dict)
                              and bytes(got[0]["data"]) == obj[0]["data"])

    def test_loads_onto_the_template_device(self, tmp_path):
        tree = {"a": torch.ones(2), "b": torch.zeros(3, device="meta")}
        save_checkpoint(str(tmp_path / "c"), {"a": torch.ones(2), "b": torch.ones(3)})
        out = load_checkpoint(str(tmp_path / "c"), tree)
        assert out["a"].device.type == "cpu" and out["b"].device.type == "meta"


class TestTree:
    def test_flatten_order_is_the_references(self):
        j, t = _trees()
        want = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(j)]
        got = [as_f32(x) for x in flatten(t)[0]]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_unflatten_rebuilds_and_checks_counts(self):
        _, t = _trees()
        leaves, spec = flatten(t)
        back = unflatten(spec, leaves)
        assert list(back) == list(t) and isinstance(back["groups"], list)
        with pytest.raises(ValueError):
            unflatten(spec, leaves[:-1])
        with pytest.raises(ValueError):
            unflatten(spec, leaves + leaves[:1])
        doubled = tree_map(lambda x: x * 2, t)
        assert torch.equal(doubled["z"], t["z"] * 2)
