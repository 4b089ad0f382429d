"""The static checks' SHD rules (``repro_torch.analysis.config_check``:
``check_sharding``, SHD000–004, and ``check_ebft_mesh_plan``, SHD005)
against the reference's, and the reference's own SHD cases
(``tests/test_analysis.py``) on the port.

The port's findings must equal the reference's code for code, severity
for severity and location for location over all 17 configs.
"""
from __future__ import annotations

import pytest

from repro.analysis import config_check as RCC
from repro.configs import get_config as ref_get_config
from repro_torch.analysis.config_check import (
    check_ebft_mesh_plan, check_model_config, check_sharding,
)
from repro_torch.configs import CONFIG_IDS, get_config


def _key(findings):
    return sorted((f.code, f.severity, f.pass_name, f.config, f.location) for f in findings)


def codes(fs):
    return {f.code for f in fs}


def errors(fs):
    return [f for f in fs if f.severity == "error"]


@pytest.mark.parametrize("name", CONFIG_IDS)
def test_sharding_findings_match_reference(name):
    cfg, ref_cfg = get_config(name), ref_get_config(name)
    assert _key(check_sharding(name, cfg)) == _key(RCC.check_sharding(name, ref_cfg))
    assert _key(check_sharding(name, cfg, multi_pod=True)) == \
        _key(RCC.check_sharding(name, ref_cfg, multi_pod=True))
    assert _key(check_ebft_mesh_plan(name, cfg)) == _key(RCC.check_ebft_mesh_plan(name, ref_cfg))


@pytest.mark.parametrize("kw", [dict(data=4, model_axis=2, microbatch=8),
                                dict(data=4, model_axis=16, microbatch=7),
                                dict(data=3, model_axis=3, microbatch=8)])
@pytest.mark.parametrize("name", ["tiny_dense", "tiny_vlm", "tiny_ssm", "tiny_moe"])
def test_mesh_plan_findings_match_reference_off_production(name, kw):
    assert _key(check_ebft_mesh_plan(name, get_config(name), **kw)) == \
        _key(RCC.check_ebft_mesh_plan(name, ref_get_config(name), **kw))


def test_config_and_sharding_clean_on_shipped():
    for name in ("tiny_dense", "llama_7b"):
        cfg = get_config(name)
        assert not errors(check_model_config(name, cfg)), name
        assert not errors(check_sharding(name, cfg)), name


def test_sharding_warns_on_nondivisible_heads():
    # llama_7b: 32 heads / model axis 16 divides -> no SHD003
    assert "SHD003" not in codes(check_sharding("llama_7b", get_config("llama_7b")))
    # qwen1_5_4b: 20 heads -> pad fallback warn
    f = check_sharding("qwen1_5_4b", get_config("qwen1_5_4b"))
    shd = [x for x in f if x.code == "SHD003"]
    assert shd and shd[0].severity == "warn"


def test_sharding_reports_a_config_that_does_not_build():
    bad = get_config("tiny_dense").replace(family="nosuch")
    f = check_sharding("bad", bad) + check_ebft_mesh_plan("bad", bad)
    assert [(x.code, x.severity, x.location) for x in f] == [
        ("SHD000", "error", "build"), ("SHD000", "error", "ebft.build")]


def test_mesh_plan_clean_layout_has_no_findings():
    # tiny_dense on a (4, 2) mesh with microbatch 8: the batch and every
    # ruled block leaf divide, so the walk runs fully sharded
    assert check_ebft_mesh_plan("tiny_dense", get_config("tiny_dense"),
                                data=4, model_axis=2, microbatch=8) == []


def test_mesh_plan_flags_indivisible_microbatch():
    fs = check_ebft_mesh_plan("tiny_dense", get_config("tiny_dense"),
                              data=4, model_axis=2, microbatch=7)
    assert any(f.code == "SHD005" and "microbatch=7" in f.message for f in fs)
    assert all(f.severity == "warn" for f in fs)


def test_mesh_plan_flags_block_replication_fallback():
    # 4 heads on a model axis of 16: the attention leaves have a rule but
    # do not divide, so they replicate: one aggregated warn
    fs = check_ebft_mesh_plan("tiny_dense", get_config("tiny_dense"),
                              data=4, model_axis=16, microbatch=8)
    hits = [f for f in fs if f.code == "SHD005" and f.location == "ebft.block0"]
    assert len(hits) == 1 and "attn/wq" in hits[0].message


def test_cli_exits_0_on_the_shipped_configs(capsys):
    """``python -m repro_torch.analysis`` on every shipped config with the
    sharding pass: exit 0, the SHD findings warn or info only."""
    import json

    from repro_torch.analysis.__main__ import main

    assert main(["--passes", "sharding", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"]["error"] == 0
    assert {f["code"] for f in payload["findings"]} == {"SHD003", "SHD004", "SHD005"}
