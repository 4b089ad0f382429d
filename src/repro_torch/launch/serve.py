"""Batched serving driver: prefill + decode with continuous batching (port
of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch tiny_dense --requests 12 \
        --slots 4 --prompt-len 32 --max-new 16 [--sparse 0.5] --device cpu

``--sparse`` prunes the (seeded-init or checkpointed) model with Wanda and
serves the sparse weights: EBFT-tuned sparse params drop into the serving
path unchanged (the same tree). ``--ckpt-dir`` restores the latest
checkpoint of a ``{"params": ...}`` tree there, in the reference's layout,
so either package serves the other's weights. Runs on the card unless
``--device cpu``. With obs on (the default) the run books the ``serve/*``
spans and metrics and ends with the ``served`` section (``--bench-out``
writes the artifact, ``--obs-jsonl`` streams the events, ``--no-obs``
turns it all off). The reference's deprecated ``--batch`` spelling of
``--slots`` is not taken. The VLM and encoder-decoder families are
refused (``launch.api.refuse_frontend_families``): the reference's
``Server`` passes the tokens alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.core.masks import prune
from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
from repro_torch.launch.api import parse, refuse_frontend_families, start_obs_run
from repro_torch.models.model import build
from repro_torch.obs import metrics as OM
from repro_torch.serving.decode import Request, Server


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The reference ``RunSpec``'s serve-kind fields, with the same names
    and defaults."""

    arch: str = "tiny_dense"
    requests: int = 12
    slots: int = 4  # continuous-batching decode slots
    prompt_len: int = 32
    max_new: int = 16
    max_len: int = 128
    sparse: float = 0.0
    ckpt_dir: str = ""
    temperature: float = 0.0
    seed: int = 0
    no_obs: bool = False
    bench_out: str = ""
    obs_jsonl: str = ""


def main(argv=None) -> Dict[int, List[int]]:
    spec, device = parse(ServeSpec, argv, "repro_torch.launch.serve", __doc__)
    device = resolve_device(device)
    cfg = get_config(spec.arch)
    refuse_frontend_families(cfg, "serve")
    run = start_obs_run(spec, "serve", device)

    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(spec.seed))
    if spec.ckpt_dir:
        latest = CK.latest_step(spec.ckpt_dir)
        if latest is not None:
            params = CK.restore(spec.ckpt_dir, {"params": params})["params"]
            print(f"loaded checkpoint step {latest}")

    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=spec.seed))
    if spec.sparse > 0:
        calib = calibration_set(corpus, 16, spec.prompt_len)
        _, params = prune(model, params, calib, method="wanda", sparsity=spec.sparse)
        print(f"serving wanda-pruned weights at sparsity {spec.sparse}")

    rng = np.random.default_rng(spec.seed)
    reqs = [Request(uid=i, prompt=corpus.sample(rng, spec.prompt_len), max_new=spec.max_new)
            for i in range(spec.requests)]
    server = Server(model, params, batch_size=spec.slots, max_len=spec.max_len,
                    temperature=spec.temperature)
    t0 = time.perf_counter()
    results = server.serve(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s, continuous batching over "
          f"{spec.slots} slots)")
    for uid in sorted(results)[:3]:
        print(f"  req {uid}: {results[uid][:8]}...")
    if run is not None:
        occ = OM.summary().get("serve/batch_occupancy", {})
        print(f"  mean batch occupancy "
              f"{(occ.get('mean') or 0.0) * 100:.0f}% over {spec.slots} slots")
        run.finish(extra={"served": {"requests": len(results), "tokens": toks,
                                     "tokens_per_s": toks / max(dt, 1e-9)}},
                   summary_path=spec.bench_out or None)
    return results


if __name__ == "__main__":
    main()
