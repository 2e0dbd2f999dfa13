"""The port's profiling and debug helpers (utils/profiling.py,
utils/debug.py) against the JAX package's, on the CPU.

``DecodeStats`` reports JAX's text for the same laps; ``trace`` writes a
Chrome trace; ``check_quant_params`` finds what JAX's finds on
tests/test_parallel.py:139-146's good and bad trees.  The kernel wrappers
run their plain versions on a CPU tensor, so the kernel-side switches are
shown on a tensor that says it lies on the card: outside
``interpret_kernels`` its wrapper goes for the kernel (a launch the test
stops), inside it runs the plain version and counts no launch.  The NaN
check of a launch and autograd's anomaly mode each raise on a planted NaN.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chatglm_q_tpu.config import ChatGLM2Config as JConfig  # noqa: E402
from chatglm_q_tpu.models import chatglm2 as JM  # noqa: E402
from chatglm_q_tpu.utils import debug as JD  # noqa: E402
from chatglm_q_tpu.utils import profiling as JP  # noqa: E402
from chatglm_q_tpu_torch import ChatGLM2Config  # noqa: E402
from chatglm_q_tpu_torch.convert import params_from_numpy  # noqa: E402
from chatglm_q_tpu_torch.ops import _build, launch_counts  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.ops.quant import quantize_linear_int4  # noqa: E402
from chatglm_q_tpu_torch.utils import debug as TD  # noqa: E402
from chatglm_q_tpu_torch.utils import profiling as TP  # noqa: E402

CFG = dict(hidden_size=256, inner_hidden_size=512, head_hidden_size=32,
           num_multi_query_groups=2, num_attention_heads=8, num_layers=2,
           vocab_size=1024, max_sequence_length=64)


def test_decode_stats_report_equals_jax():
    laps = [0.125, 0.0311, 0.0298, 0.0307, 0.03]
    jax_stats, port_stats = JP.DecodeStats(), TP.DecodeStats()
    jax_stats.step_times, port_stats.step_times = list(laps), list(laps)
    assert port_stats.report(57, 4) == jax_stats.report(57, 4)
    assert port_stats.prefill_latency == jax_stats.prefill_latency
    assert port_stats.decode_tps == pytest.approx(jax_stats.decode_tps)
    empty = TP.DecodeStats()
    assert empty.report(0, 0) == JP.DecodeStats().report(0, 0)
    empty.start()
    empty.lap()
    assert len(empty.step_times) == 1 and empty.step_times[0] >= 0


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with TP.trace(str(tmp_path / "tr")) as prof:
        (x @ x).sum()
    assert any("aten::mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_check_quant_params_agrees_with_jax():
    jtree = JM.init_params(jax.random.PRNGKey(8), JConfig(**CFG), "int4g32", jnp.float32)
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    assert TD.check_quant_params(tree, ChatGLM2Config(**CFG), "int4g32") == []
    assert JD.check_quant_params(jtree, JConfig(**CFG), "int4g32") == []
    jbad, bad = dict(jtree), dict(tree)
    jbad["lm_head"] = {k: v[: v.shape[0] // 2] for k, v in jtree["lm_head"].items()}
    bad["lm_head"] = {k: v[: v.shape[0] // 2] for k, v in tree["lm_head"].items()}
    want = JD.check_quant_params(jbad, JConfig(**CFG), "int4g32")
    assert want and TD.check_quant_params(bad, ChatGLM2Config(**CFG), "int4g32") == want
    # a dtype problem: int8 weights where int4g32 wants packed bytes
    bad["lm_head"] = dict(tree["lm_head"], weight=tree["lm_head"]["weight"].view(torch.int8))
    assert TD.check_quant_params(bad, ChatGLM2Config(**CFG), "int4g32") == [
        "lm_head.weight: dtype torch.int8 != torch.uint8"]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: what a kernel wrapper
    looks at before it launches."""

    @property
    def is_cuda(self):
        return True


def _int4_inputs():
    gen = torch.Generator().manual_seed(2)
    p = quantize_linear_int4(torch.randn(256, 64, generator=gen) * 0.1)
    x = torch.randn(4, 256, generator=gen, dtype=torch.float32)
    return x, p["weight"], p["weight_scale"]


class _Launch(Exception):
    pass


def _no_launch(name, *args):
    raise _Launch(name)


def test_interpret_kernels_runs_the_plain_versions(monkeypatch):
    x, packed, scale = _int4_inputs()
    on_card = x.as_subclass(_OnCard)
    assert _build.on_card(on_card) and not _build.on_card(x)
    monkeypatch.setattr(_build, "call", _no_launch)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    with pytest.raises(_Launch, match="chatglm_int4_splitk_mma"):  # f32 x: B1's f32 split-K
        QM.int4g32_matmul(on_card, packed, scale)
    before = launch_counts()
    with TD.interpret_kernels():
        assert not _build.on_card(on_card)
        got = QM.int4g32_matmul(on_card, packed, scale)
        got_t = QM.int4g32_matmul_t(got.as_subclass(_OnCard), packed, scale)
    assert not _build.INTERPRET
    assert launch_counts() == before
    want = QM.int4g32_matmul_plain(x, packed, scale)
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert torch.equal(got_t.as_subclass(torch.Tensor),
                       QM.int4g32_matmul_t_plain(want, packed, scale))


def test_enable_nan_checks_raises_on_a_planted_nan():
    def some_kernel():
        pass

    some_kernel.launches = 0
    out = torch.ones(3)
    out[1] = float("nan")
    try:
        TD.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="some_kernel"):
            _build.launched(some_kernel, out)
        assert _build.launched(some_kernel, torch.ones(3)).sum() == 3
        assert some_kernel.launches == 2
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        TD.enable_nan_checks(False)
    assert not _build.NAN_CHECKS and not torch.is_anomaly_enabled()
    assert _build.launched(some_kernel, out) is out  # off: counted, not checked
