#!/usr/bin/env python3
"""The port's driver against the JAX reference's functions, on the CPU.

    PYTHONPATH=src python ref_compare.py --method flap [--spread]

Runs ``repro_torch.launch.ebft_run.run`` with ``--baselines dsnot,mask,lora``
at the driver's defaults (tiny_dense, seq 128, 64 calibration segments,
sparsity 0.7; ``--epochs`` 4) on the reference's seeded weights, and the
reference's functions in the order its driver calls them (LoRA from the
reference's own adapter init, carried across), and prints one JSON line:
each perplexity of both and their relative difference. With ``--spread``
it also runs the reference's mask tuning and LoRA again from starts moved
by a relative 1e-6 (mask tuning's bonus, LoRA's A), several times, and
prints how far the reference's own perplexity moves: the part of a
difference that the algorithm's sensitivity explains.
"""
from __future__ import annotations

import argparse
import json
import time

MOVES = (1 - 1e-6, 1 + 1e-6, 1 + 2e-6, 1 - 3e-6)


def _lora_port(ref_lora):
    """The reference's adapter tree (None at the other leaves) as the
    port's (only the prunable leaves' paths)."""
    import numpy as np
    import torch

    out = {}
    for k, v in ref_lora.items():
        if isinstance(v, dict) and set(v) == {"A", "B"}:
            out[k] = {n: torch.tensor(np.asarray(a)) for n, a in v.items()}
        elif isinstance(v, dict):
            sub = _lora_port(v)
            if sub:
                out[k] = sub
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="wanda",
                    choices=("magnitude", "wanda", "sparsegpt", "dsnot", "flap"))
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from repro.configs import get_config as ref_config
    from repro.core import ebft as REBFT
    from repro.core import lora as RLORA
    from repro.core import mask_tuning as RMT
    from repro.core.evaluate import perplexity as ref_ppl
    from repro.core.masks import prune as ref_prune
    from repro.data import tokens as RTOK
    from repro.models.model import build as ref_build
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.core import lora as LORA
    from repro_torch.launch import ebft_run

    spec = ebft_run.RunSpec(pretrain_steps=0, epochs=args.epochs, method=args.method,
                            baselines="dsnot,mask,lora", bench_out="")
    model = ref_build(ref_config(spec.arch))
    params = model.init(jax.random.PRNGKey(spec.seed))
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=model.cfg.vocab_size,
                                                    seed=spec.seed))
    calib = RTOK.calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = RTOK.eval_set(corpus, ebft_run.EVAL_SAMPLES, spec.seq)
    lcfg = RLORA.LoRAConfig(steps=ebft_run.LORA.steps, lr=ebft_run.LORA.lr)

    def lora_ppl(masks, pruned, move=1.0):
        init = RLORA.init_lora
        RLORA.init_lora = lambda p, c: jax.tree.map(lambda a: a * move, init(p, c))
        try:
            it = RTOK.corpus_iterator(corpus, batch=8, seq_len=spec.seq, seed=9)
            return ref_ppl(model, RLORA.finetune_lora(model, pruned, masks, it, lcfg), ev)
        finally:
            RLORA.init_lora = init

    def mask_ppl(masks, move=1.0):
        mt, _ = RMT.finetune_masks(model, params, masks, spec.sparsity, calib, bonus=0.1 * move)
        return ref_ppl(model, mt, ev)

    t0 = time.perf_counter()
    ref = {"dense": ref_ppl(model, params, ev)}
    masks, pruned = ref_prune(model, params, calib, method=spec.method, sparsity=spec.sparsity)
    ref[spec.method] = ref_ppl(model, pruned, ev)
    tuned, _ = REBFT.finetune(model, params, pruned, masks, calib,
                              REBFT.EBFTConfig(lr=spec.lr, epochs=spec.epochs))
    ref["EBFT"] = ref_ppl(model, tuned, ev)
    init = spec.method if spec.method != "dsnot" else "wanda"
    _, ds = ref_prune(model, params, calib, method="dsnot", sparsity=spec.sparsity,
                      dsnot_init=init)
    ref["DSnoT"] = ref_ppl(model, ds, ev)
    ref["mask-tune"] = mask_ppl(masks)
    ref["LoRA"] = lora_ppl(masks, pruned)
    t_ref = time.perf_counter() - t0

    ref_a = _lora_port(RLORA.init_lora(pruned, lcfg))
    LORA.init_lora = lambda *a, **k: ref_a
    t0 = time.perf_counter()
    res = ebft_run.run(get_config(spec.arch), spec, "cpu",
                       params=interop.params_to_torch(jax.tree.map(np.asarray, params), "cpu"))
    out = dict(method=spec.method, seq=spec.seq, calib_samples=spec.calib_samples,
               sparsity=spec.sparsity, epochs=spec.epochs, ref_s=t_ref,
               port_s=time.perf_counter() - t0, ref=ref, port=res.perplexity,
               rel={k: res.perplexity[k] / v - 1 for k, v in ref.items()})
    if args.spread:
        out["moves"] = MOVES
        out["ref_spread"] = {
            "mask-tune": [mask_ppl(masks, m) / ref["mask-tune"] - 1 for m in MOVES],
            "LoRA": [lora_ppl(masks, pruned, m) / ref["LoRA"] - 1 for m in MOVES]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
