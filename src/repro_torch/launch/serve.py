"""Serving entry point: the batched-request decode loop.

Counterpart of the reference's ``repro.launch.serve``. Prefills each
request's prompt (token-by-token decode into the cache), then decodes
greedily; DeepSeek-V3's MLA latent context runs on the card's
``mla_flash_decode`` kernel at every step. Whisper first runs its
encoder once over each request's (stubbed) audio frames and fills the
decoder's cross-attention cache. Weights are random (made from ``seed``)
unless ``params`` is given; nothing is downloaded.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --requests 4 --prompt-len 16 --gen 32 [--full] [--device cpu]

The CLI serves the reference's smoke config of ``--arch`` (2 layers;
DeepSeek-V3's second is MoE), or with ``--full`` the whole published
config. A model larger than the device stops with ``MemoryError``
naming its bytes (:func:`repro_torch.models.model.init_params`): there
is no fall-back to a smaller config or to the CPU. DeepSeek-V3 at full
width fits one card only cut in depth (``cfg=CONFIG.with_overrides(
num_layers=5)``, 54.6 GB, as ``chip_smoke.py`` serves it).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import all_arch_ids, get_config, get_smoke_config
from ..models import model as M
from ..models.common import dtype_of
from ..runtime.engine import resolve_device
from .steps import make_decode_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_batch(
    arch: str,
    *,
    smoke: bool = True,
    requests: int = 4,
    prompt_len: int = 16,
    gen_len: int = 32,
    seed: int = 0,
    params=None,
    cfg=None,
    device="cuda",
) -> dict:
    """Serve ``requests`` prompts of ``prompt_len`` tokens (drawn from
    ``np.random.default_rng(seed)`` as the reference draws them) and
    generate ``gen_len`` tokens each, greedily. An encoder-decoder config
    draws each request's frames ``(encoder_seq, d_model)`` from the same
    generator after the prompts, in the model's dtype, and fills the cross
    cache (:func:`~repro_torch.models.model.prefill_cross_cache`) before
    the prompts. Returns the tokens ``(requests, gen_len)`` and the
    host-clock seconds of the encoder (0 without one), the prefill and the
    decode (each ending in a device sync) with the decode rate.
    ``device="cuda"`` without a card raises ``RuntimeError``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if params is None:
        params = M.init_params(cfg, seed, device=dev)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, min(cfg.vocab_size, 1000), size=(requests, prompt_len))
    prompts = torch.from_numpy(prompts.astype(np.int32)).to(dev)

    max_seq = prompt_len + gen_len + 1
    cache = M.init_cache(cfg, requests, max_seq, device=dev)
    step = make_decode_step(cfg)
    t_encode = 0.0
    with torch.no_grad():
        if cfg.encoder_layers:
            frames = rng.normal(0, 0.02, size=(requests, cfg.encoder_seq, cfg.d_model))
            frames = torch.from_numpy(frames).to(dtype_of(cfg)).to(dev)
            _sync(dev)
            t0 = time.perf_counter()
            cache = M.prefill_cross_cache(cfg, params, cache, frames)
            _sync(dev)
            t_encode = time.perf_counter() - t0
        _sync(dev)
        t0 = time.perf_counter()
        # Prefill: feed prompt tokens through the decode path.
        tok = None
        for t in range(prompt_len):
            tok, cache = step(params, cache, prompts[:, t : t + 1], t)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        # Greedy generation.
        generated = []
        t0 = time.perf_counter()
        for t in range(prompt_len, prompt_len + gen_len):
            generated.append(tok[:, 0])
            tok, cache = step(params, cache, tok, t)
        _sync(dev)
        t_gen = time.perf_counter() - t0
    out_tokens = torch.stack(generated, dim=1).cpu().numpy()
    return {
        "tokens": out_tokens,
        "encode_s": t_encode,
        "prefill_s": t_prefill,
        "decode_s": t_gen,
        "tokens_per_s": requests * gen_len / max(t_gen, 1e-9),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_arch_ids())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = serve_batch(
        args.arch,
        smoke=args.smoke,
        requests=args.requests,
        prompt_len=args.prompt_len,
        gen_len=args.gen,
        device=args.device,
    )
    print(
        f"generated {res['tokens'].shape} tokens; "
        f"prefill {res['prefill_s']:.2f}s decode {res['decode_s']:.2f}s "
        f"({res['tokens_per_s']:.1f} tok/s)"
    )


if __name__ == "__main__":
    main()
