"""Each launcher's command line as one view of its spec dataclass, and the
obs run each launcher opens (the part of ``repro.launch.api`` the port's
launchers use): a flag ``--field-name`` per field, with the field's type
and default (a bool field is a switch), and ``--device``; and the pipeline
and serving drivers' refusal of the families whose batch carries a stub
frontend's arrays (``refuse_frontend_families``)."""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple


def refuse_frontend_families(cfg, driver: str) -> None:
    """The reference's ``ebft_run`` and ``Server`` pass the tokens alone, so
    its ``--arch tiny_vlm`` stops at the missing ``patches`` and its
    ``--arch tiny_encdec`` at the missing ``frames``; the port's drivers
    refuse both families before any work (ROADMAP.md C.4)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{driver} does not run the encdec family ({cfg.name}): its batch needs frames, "
            "which the reference's driver never passes (ROADMAP.md C.4). The library calls "
            "run it with extra_batch={'frames': ...}: core.masks.prune, "
            "core.ebft.finetune, core.evaluate.perplexity and cloze_accuracy, "
            "core.mask_tuning.finetune_masks, core.lora.finetune_lora (extra_batch_fn), "
            "the model's prefill (batch with frames) and decode_step, and launch.train, "
            "which draws the frames as the reference's does")
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{driver} does not run the vlm family ({cfg.name}): its batch needs patches, "
            "which the reference's driver never passes (ROADMAP.md C.4). The library calls "
            "run it with extra_batch={'patches': ...}: core.masks.prune, "
            "core.ebft.finetune, core.evaluate.perplexity and cloze_accuracy, "
            "core.mask_tuning.finetune_masks, core.lora.finetune_lora (extra_batch_fn), "
            "models.vlm.prefill_multimodal with the model's decode_step, and "
            "launch.train, which draws the patches as the reference's does")


def quiet(*_args, **_kw) -> None:
    """What a rank other than 0 prints: nothing."""


def parse(spec_cls, argv: Optional[Sequence[str]], prog: str, description: str,
          choices: Optional[Dict[str, Sequence]] = None,
          device: bool = True) -> Tuple[object, Optional[str]]:
    """(spec, device) from ``argv``; device None means the card. With
    ``device=False`` there is no ``--device`` (a launcher that uses no
    device: the dry run) and the device is None."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    choices = choices or {}
    for f in dataclasses.fields(spec_cls):
        flag = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(flag, action="store_true", default=f.default)
        else:
            ap.add_argument(flag, type=type(f.default), default=f.default,
                            choices=choices.get(f.name))
    if device:
        ap.add_argument("--device", default=None,
                        help="cuda (the default) or cpu; never falls back")
    args = vars(ap.parse_args(argv))
    return spec_cls(**{k: v for k, v in args.items() if k != "device"}), args.get("device")


def to_manifest(spec, kind: str) -> Dict[str, Any]:
    """The manifest header of the reference's ``RunSpec.to_manifest``:
    ``run_spec`` (``kind`` and every field of the spec) and the flat keys
    the reference's artifacts carry. The port's EBFT is the per-epoch loop:
    ``fused_epochs`` False, ``prefetch_depth`` 0; ``mesh`` is the
    requested (data, model) axes, as the reference's."""
    out: Dict[str, Any] = {"run_spec": {"kind": kind, **dataclasses.asdict(spec)}}
    if kind == "ebft":
        out.update({
            "ebft_lr": spec.lr, "ebft_epochs": spec.epochs,
            "calib_samples": spec.calib_samples, "seq": spec.seq, "seed": spec.seed,
            "fused_epochs": False, "prefetch_depth": 0,
            "mesh": {"data": spec.mesh_data, "model": spec.mesh_model},
        })
    elif kind == "train":
        out.update({"steps": spec.steps, "batch": spec.batch, "seq": spec.seq})
    elif kind == "serve":
        out.update({"batch_slots": spec.slots, "requests": spec.requests})
    return out


def start_obs_run(spec, kind: str, device, name: Optional[str] = None, **kw):
    """``obs.run.start_run`` with ``spec`` as the manifest source, as the
    reference's ``RunSpec.start_obs_run``; None when ``spec.no_obs``, so a
    launcher can write ``run = start_obs_run(...)`` unconditionally."""
    if spec.no_obs:
        return None
    from repro_torch.obs.run import start_run

    base: Dict[str, Any] = {"config": spec.arch, "jsonl_path": spec.obs_jsonl or None}
    if kind == "ebft":
        base.update(method=spec.method, sparsity=spec.sparsity, pattern=spec.pattern or None)
    elif kind == "serve":
        base.update(sparsity=spec.sparse or None)
    base["extra_manifest"] = to_manifest(spec, kind)
    base.update(kw)
    return start_run(name or ("ebft_run" if kind == "ebft" else kind), device=device, **base)
