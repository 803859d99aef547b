#!/usr/bin/env python3
"""xLSTM-350M's gap between prefill and decode logits, in the reference
and in the port, on the CPU.

At the published widths (24 layers, or the first ``--layers``; bf16, or
float32 with ``--dtype float32``) and the reference's ``init_params`` from ``PRNGKey(seed)``
(carried to the port by ``params_from_jax``), both packages run
chip_smoke's serve prompts (4 x 256 from ``np.random.default_rng(seed)``,
as ``serve_batch`` draws them) two ways: the prefill step (one ``forward``, the last position's
logits) and the decode step over the prompt token by token (its logits
at position 255). The reference runs jitted, as its serve loop and
prefill step run it, and with ``--op-by-op`` also under
``jax.disable_jit()`` (each operation rounded to bf16, as the port's
eager operations are); the port runs eagerly. For each package the script
prints the largest |prefill - decode| over the 4 x vocab logits, its
share of max |decode logits|, and on how many requests the greedy token
is equal; then the port's prefill and decode logits against the
reference's. It reads only the CPU and imports both packages (a parity
measurement, like the tests).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/xlstm_prefill_gap.py [--seed 0] \
        [--op-by-op] [--dtype float32] [--layers N] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel

ARCH = "xlstm-350m"
REQUESTS, PROMPT = 4, 256


def gap(prefill: np.ndarray, decode: np.ndarray) -> dict:
    diff = float(np.abs(prefill - decode).max())
    scale = float(np.abs(decode).max())
    same = int((prefill.argmax(-1) == decode.argmax(-1)).sum())
    return {"max_abs_diff": diff, "max_abs_logits": scale, "share": diff / scale,
            "greedy_equal": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--op-by-op", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    depth = {"num_layers": args.layers} if args.layers else {}
    jcfg = jconfigs.get_config(ARCH).with_overrides(dtype=args.dtype, **depth)
    tcfg = tconfigs.get_config(ARCH).with_overrides(dtype=args.dtype, **depth)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, min(jcfg.vocab_size, 1000), size=(REQUESTS, PROMPT)).astype(np.int32)
    out = {"arch": ARCH, "dtype": args.dtype, "layers": jcfg.num_layers, "requests": REQUESTS,
           "prompt": PROMPT, "seed": args.seed}

    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(args.seed))
    for mode in ("jitted", "op_by_op") if args.op_by_op else ("jitted",):
        t0 = time.perf_counter()
        wrap = jax.jit if mode == "jitted" else (lambda f: f)
        with jax.disable_jit() if mode == "op_by_op" else contextlib.nullcontext():
            jpre = np.asarray(wrap(jsteps.make_prefill_step(jcfg))(
                jparams, {"tokens": jnp.asarray(prompts)}), np.float32)
            step = wrap(lambda p, c, tok, pos: jmodel.decode_step(jcfg, p, c, tok, pos))
            cache = jmodel.init_cache(jcfg, REQUESTS, PROMPT + 1)
            for t in range(PROMPT):
                logits, cache = step(jparams, cache, jnp.asarray(prompts[:, t : t + 1]),
                                     jnp.int32(t))
        jdec = np.asarray(logits[:, -1], np.float32)
        out[f"reference_{mode}"] = gap(jpre, jdec)
        out[f"reference_{mode}_s"] = time.perf_counter() - t0
        print(f"reference ({mode}):", json.dumps(out[f"reference_{mode}"]), flush=True)

    t0 = time.perf_counter()
    tparams = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    del jparams, cache
    toks = torch.from_numpy(prompts)
    with torch.no_grad():
        tpre = tsteps.make_prefill_step(tcfg)(tparams, {"tokens": toks}).float().numpy()
        tcache = tmodel.init_cache(tcfg, REQUESTS, PROMPT + 1, device="cpu")
        for t in range(PROMPT):
            logits, tcache = tmodel.decode_step(tcfg, tparams, tcache, toks[:, t : t + 1], t)
    tdec = logits[:, -1].float().numpy()
    out["port"] = gap(tpre, tdec)
    out["port_s"] = time.perf_counter() - t0
    print("port (CPU, eager):", json.dumps(out["port"]), flush=True)
    out["port_vs_reference"] = {
        "prefill_max_abs_diff": float(np.abs(tpre - jpre).max()),
        "decode_max_abs_diff": float(np.abs(tdec - jdec).max()),
        "prefill_greedy_equal": int((tpre.argmax(-1) == jpre.argmax(-1)).sum()),
        "decode_greedy_equal": int((tdec.argmax(-1) == jdec.argmax(-1)).sum()),
    }
    print("port vs reference:", json.dumps(out["port_vs_reference"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
