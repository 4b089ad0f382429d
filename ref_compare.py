#!/usr/bin/env python3
"""The port's driver against the JAX reference's functions, on the CPU.

    PYTHONPATH=src python ref_compare.py --method flap [--pretrain-steps 200] [--spread]

Runs ``repro_torch.launch.ebft_run.run`` with ``--baselines dsnot,mask,lora``
at the driver's defaults (tiny_dense, seq 128, 64 calibration segments,
sparsity 0.7; ``--epochs`` 4; ``--pretrain-steps`` 0, or N AdamW steps on
batches of 32) on the reference's seeded weights, and the reference's
functions in the order its driver calls them (its ``pretrain``; LoRA from
the reference's own adapter init, carried across), and prints one JSON
line: each perplexity of both and their relative difference, and with
pretraining the relative difference of each recorded pretraining loss.
With ``--spread`` it also runs the reference's mask tuning and LoRA again
from starts moved by a relative 1e-6 (mask tuning's bonus, LoRA's A), and
with pretraining its whole run from pretraining weights moved so, several
times, and prints how far the reference's own perplexities move, and
whether each difference is within twice that: the part of a difference
that the algorithms' sensitivity explains.
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
    ap.add_argument("--pretrain-steps", type=int, default=0)
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
    from repro.launch.ebft_run import pretrain as ref_pretrain
    from repro.models.model import build as ref_build
    from repro.obs import metrics as OM
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.core import lora as LORA
    from repro_torch.launch import ebft_run

    spec = ebft_run.RunSpec(pretrain_steps=args.pretrain_steps, epochs=args.epochs,
                            method=args.method, baselines="dsnot,mask,lora", bench_out="")
    model = ref_build(ref_config(spec.arch))
    params0 = model.init(jax.random.PRNGKey(spec.seed))
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=model.cfg.vocab_size,
                                                    seed=spec.seed))

    def pretrained(p):
        """The reference's pretraining of ``p`` and its recorded losses."""
        if not spec.pretrain_steps:
            return p, []
        OM.set_registry(OM.Metrics())
        try:
            p = ref_pretrain(model, p, corpus, spec.pretrain_steps, spec.batch, spec.seq,
                             ebft_run.PRETRAIN_LR, say=lambda *_: None)
            return p, [v for _, v in OM.series("pretrain/loss").points]
        finally:
            OM.set_registry(None)

    t0 = time.perf_counter()
    params, ref_losses = pretrained(params0)
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

    def mask_ppl(p, masks, move=1.0):
        mt, _ = RMT.finetune_masks(model, p, masks, spec.sparsity, calib, bonus=0.1 * move)
        return ref_ppl(model, mt, ev)

    def chain(p):
        """Every perplexity of the driver from the dense weights ``p``, and
        the masks and pruned weights."""
        out = {"dense": ref_ppl(model, p, ev)}
        masks, pruned = ref_prune(model, p, calib, method=spec.method, sparsity=spec.sparsity)
        out[spec.method] = ref_ppl(model, pruned, ev)
        tuned, _ = REBFT.finetune(model, p, pruned, masks, calib,
                                  REBFT.EBFTConfig(lr=spec.lr, epochs=spec.epochs))
        out["EBFT"] = ref_ppl(model, tuned, ev)
        _, ds = ref_prune(model, p, calib, method="dsnot", sparsity=spec.sparsity,
                          dsnot_init=spec.method if spec.method != "dsnot" else "wanda")
        out["DSnoT"] = ref_ppl(model, ds, ev)
        out["mask-tune"] = mask_ppl(p, masks)
        out["LoRA"] = lora_ppl(masks, pruned)
        return out, masks, pruned

    ref, masks, pruned = chain(params)
    t_ref = time.perf_counter() - t0

    ref_a = _lora_port(RLORA.init_lora(pruned, lcfg))
    LORA.init_lora = lambda *a, **k: ref_a
    t0 = time.perf_counter()
    res = ebft_run.run(get_config(spec.arch), spec, "cpu",
                       params=interop.params_to_torch(jax.tree.map(np.asarray, params0), "cpu"))
    out = dict(method=spec.method, seq=spec.seq, calib_samples=spec.calib_samples,
               sparsity=spec.sparsity, epochs=spec.epochs, pretrain_steps=spec.pretrain_steps,
               batch=spec.batch, ref_s=t_ref, port_s=time.perf_counter() - t0, ref=ref,
               port=res.perplexity, rel={k: res.perplexity[k] / v - 1 for k, v in ref.items()})
    if spec.pretrain_steps:
        port_losses = [loss for _, loss, _ in res.pretrain_losses]
        out["pretrain_loss"] = dict(steps=[s for s, _, _ in res.pretrain_losses], ref=ref_losses,
                                    port=port_losses,
                                    rel=[a / b - 1 for a, b in zip(port_losses, ref_losses)])
    if args.spread:
        out["moves"] = MOVES
        out["ref_spread"] = {
            "mask-tune": [mask_ppl(params, masks, m) / ref["mask-tune"] - 1 for m in MOVES],
            "LoRA": [lora_ppl(masks, pruned, m) / ref["LoRA"] - 1 for m in MOVES]}
        spreads = [out["ref_spread"]]
        if spec.pretrain_steps:  # every perplexity, from moved pretraining starts
            moved = [chain(pretrained(jax.tree.map(lambda a: a * m, params0))[0])[0]
                     for m in MOVES]
            out["ref_spread_pretrain"] = {k: [r[k] / v - 1 for r in moved]
                                          for k, v in ref.items()}
            spreads.append(out["ref_spread_pretrain"])
        # a difference twice the reference's own largest move or less is
        # what its sensitivity explains
        worst = {}
        for sp in spreads:
            for k, v in sp.items():
                worst[k] = max(worst.get(k, 0.0), max(map(abs, v)))
        out["within_2x_spread"] = {k: abs(out["rel"][k]) <= 2 * w for k, w in worst.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
