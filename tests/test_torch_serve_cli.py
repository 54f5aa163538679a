"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the reference's (``python -m repro.launch.serve``) on one random
checkpoint of the bench model, written by the reference's
``checkpoint.save``: with the same small arguments (dense, and paged with
a shared prefix and drift telemetry) both print the same lines, the
summary line's tokens/s (a host-clock rate) aside. The port's runs pass
``--device cpu``. CPU, float32."""
import pathlib
import re
import sys

import jax
import pytest

from repro.checkpoint.checkpoint import save
from repro.config.registry import get_config
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--n", "4", "--max-new", "16"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = serve.bench_config()
    jcfg = get_config("llada-8b").reduced(num_layers=4, max_d_model=256,
                                          vocab_size=512)
    assert (jcfg.num_layers, jcfg.d_model, jcfg.num_heads, jcfg.d_ff,
            jcfg.vocab_size) == (cfg.num_layers, cfg.d_model,
                                 cfg.num_heads, cfg.d_ff, cfg.vocab_size)
    path = str(tmp_path_factory.mktemp("ckpt") / "bench.msgpack")
    save(path, JM.init_params(jax.random.key(5), jcfg), meta={"steps": 0})
    return path


def _masked(out):
    return [re.sub(r"tokens/s=[0-9.]+", "tokens/s=*", line)
            for line in out.splitlines()]


@pytest.mark.parametrize("extra", [
    [], ["--cache-layout", "paged", "--shared-prefix",
         "System: you answer in one short line. ", "--drift"]])
def test_serve_prints_the_reference_lines(ckpt, extra, monkeypatch, capsys):
    args = ["--ckpt", ckpt] + ARGS + extra
    # the reference launcher reads its bench config from benchmarks/
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jax_serve.main()
    want = capsys.readouterr().out
    serve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    lines = got.splitlines()
    assert lines[1].startswith("# 4 requests") and len(lines) >= 5
    if extra:
        assert any(line.startswith("# pages: capacity=") for line in lines)
        assert any(line.startswith("# drift[gsm8k-syn]") for line in lines)


@pytest.mark.parametrize("flag,item", [
    (["--spec-decode"], "item 4"),
    (["--draft-max-steps", "2"], "item 4"), (["--prefix-cache"], "item 5"),
    (["--prefix-cache-pages", "64"], "item 5"),
    (["--prefix-cache-watermark", "0.1"], "item 5"),
    (["--data-parallel", "2"], "item 8"),
    (["--model-parallel", "2"], "item 8")])
def test_serve_refuses_unported_flags(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main(["--ckpt", "absent.msgpack", "--device", "cpu"] + flag)
