"""Each launcher's command line as one view of its spec dataclass (the
part of ``repro.launch.api`` the port's launchers use): a flag
``--field-name`` per field, with the field's type and default, and
``--device``."""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence, Tuple


def parse(spec_cls, argv: Optional[Sequence[str]], prog: str, description: str,
          choices: Optional[Dict[str, Sequence]] = None) -> Tuple[object, Optional[str]]:
    """(spec, device) from ``argv``; device None means the card."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    choices = choices or {}
    for f in dataclasses.fields(spec_cls):
        ap.add_argument("--" + f.name.replace("_", "-"), type=type(f.default),
                        default=f.default, choices=choices.get(f.name))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; never falls back")
    args = vars(ap.parse_args(argv))
    device = args.pop("device")
    return spec_cls(**args), device
