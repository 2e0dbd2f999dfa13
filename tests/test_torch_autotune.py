"""The plan table (``chatglm_q_tpu_torch.ops.autotune``), the counterpart
of the JAX package's ``ops/autotune.py``: its precedence (an override, the
user's table, the packaged table, the built-in plan), ``record`` /
``reload`` / ``lookup`` round trips in a temporary path, the rule that an
entry the kernel would refuse raises naming its key, and that with the
packaged table (``{}``) every plan at the main path's shapes (ChatGLM2-6B's
six linears and the lm_head at M = 1, 4, 36, 128, 512 and 1024) is today's
built-in plan.  The sweep's candidates are all plans the kernels take.
The JAX module's API on the same kind of table is held beside it."""
import json

import pytest

pytest.importorskip("torch")

from chatglm_q_tpu.ops import autotune as JAT  # noqa: E402
from chatglm_q_tpu_torch.ops import autotune as AT  # noqa: E402
from chatglm_q_tpu_torch.ops import dyn_matmul as D  # noqa: E402
from chatglm_q_tpu_torch.ops import quant_matmul as QM  # noqa: E402
from chatglm_q_tpu_torch.utils import autotune_sweep as S  # noqa: E402

SHAPES = [(4096, 4096), (4096, 512), (4096, 13824), (13824, 4096), (4096, 65536)]
MAIN_M = (1, 4, 36, 128, 512, 1024)


@pytest.fixture
def table(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(AT.ENV, str(path))
    AT.reload()
    yield path
    AT.reload()


def test_table_path_and_key_follow_the_jax_module(tmp_path, monkeypatch):
    monkeypatch.delenv(AT.ENV, raising=False)
    assert AT.table_path().endswith(".cache/chatglm_q_tpu_torch/autotune.json")
    monkeypatch.setenv(AT.ENV, str(tmp_path / "t.json"))
    assert AT.table_path() == str(tmp_path / "t.json")
    assert AT.key("int4_mma", 128, 4096, 512) == f"{AT.device_kind()}|int4_mma|m128k4096n512"
    assert JAT._key("int4", 128, 4096, 512).split("|")[1:] == ["int4", "m128k4096n512"]
    assert " " not in AT.device_kind()


def test_packaged_table_is_empty_and_every_main_path_plan_is_builtin(table):
    with open(AT.packaged_path()) as f:
        assert json.load(f) == {}
    n = 0
    for K, N in SHAPES:
        for M in MAIN_M:
            bm, ns, sps, ctas = QM.wg_plan(M, K, N)
            assert QM.mma_plan(M, K, N) == (bm, ns, QM.MMA_STAGE_GROUPS * sps if ns > 1
                                            else K // 32, ctas)
            assert QM.int8_mma_plan(M, K, N) == QM.wg_plan(M, K, N)
            assert QM.t_mma_plan(M, K, N) == QM.t_mma_plan(M, K, N, "int8") == QM.wg_plan(M, N, K)
            assert D.dyn_plan(M, K, N) == D.dyn_plan(M, K, N, int4=True) == \
                QM.wg_plan(M, K, N, step=QM.DYN_STEP)
            n += 5
            if M <= QM.SMALL_M_MAX:
                for xb, i8 in QM.SPLITK_KERNELS:
                    if (xb == 2 and not i8) or M <= QM.MMA_MIN_M:
                        assert QM.splitk_plan(M, K, N, xb, i8) == \
                            QM.builtin_splitk_plan(M, K, N, xb, i8)
                        n += 1
    assert n > 150
    # two of today's plans, as PERF.md and tests/test_torch_int4_splitk.py know them
    assert QM.splitk_plan(1, 4096, 4096) == (1, 16, 16, 8, 8)
    assert QM.mma_plan(512, 4096, 4096)[0] == 128


def test_record_reload_lookup_round_trip(table):
    assert AT.lookup("int4_mma", 128, 4096, 4096) is None
    name = AT.record("int4_mma", 128, 4096, 4096, (128, 2, 64, 64), us=12.3456)
    assert json.loads(table.read_text()) == {name: {"plan": [128, 2, 64, 64], "us": 12.346}}
    assert AT.lookup("int4_mma", 128, 4096, 4096) == {"plan": [128, 2, 64, 64], "us": 12.346}
    AT.record("int4_splitk", 8, 4096, 512, (1, 8, 4, 32, 32))
    assert len(json.loads(table.read_text())) == 2  # the rewrite keeps the other keys
    assert AT.lookup("int4_mma", 128, 4096, 4096)["plan"] == [128, 2, 64, 64]
    # an edit behind the module's back shows after reload
    on_disk = json.loads(table.read_text())
    on_disk[name]["plan"] = [64, 1, 128, 128]
    table.write_text(json.dumps(on_disk))
    assert AT.lookup("int4_mma", 128, 4096, 4096)["plan"] == [128, 2, 64, 64]
    AT.reload()
    assert AT.lookup("int4_mma", 128, 4096, 4096)["plan"] == [64, 1, 128, 128]


def test_precedence_override_user_packaged_builtin(table, tmp_path, monkeypatch):
    builtin = QM.mma_plan(128, 4096, 4096)
    packaged = tmp_path / "packaged.json"
    monkeypatch.setattr(AT, "_PACKAGED", str(packaged))
    packaged.write_text(json.dumps({AT.key("int4_mma", 128, 4096, 4096):
                                    {"plan": [128, 4, 32, 128]}}))
    AT.reload()
    assert QM.mma_plan(128, 4096, 4096) == (128, 4, 32, 128)  # packaged over built-in
    AT.record("int4_mma", 128, 4096, 4096, (64, 2, 64, 132))
    assert QM.mma_plan(128, 4096, 4096) == (64, 2, 64, 132)   # the user's over packaged
    assert QM.mma_plan(100, 4096, 4096) == (64, 2, 64, 132)   # the same 128-row bucket
    assert QM.mma_plan(129, 4096, 4096) != (64, 2, 64, 132)   # another bucket
    with AT.override("int4_mma", 128, 4096, 4096, (128, 1, 128, 32)):
        assert QM.mma_plan(128, 4096, 4096) == (128, 1, 128, 32)  # override over all
    assert QM.mma_plan(128, 4096, 4096) == (64, 2, 64, 132)
    packaged.write_text("{}")
    table.write_text("{}")
    AT.reload()
    assert QM.mma_plan(128, 4096, 4096) == builtin


@pytest.mark.parametrize("kernel, bucket, K, N, plan, call", [
    ("int4_splitk", 8, 4096, 4096, (1, 8, 1, 1, 8), lambda: QM.splitk_plan(1, 4096, 4096)),
    ("int4_splitk", 8, 4096, 4096, (2, 16, 16, 8, 8), lambda: QM.splitk_plan(4, 4096, 4096)),
    ("int8_splitk", 8, 4096, 4096, (1, 8, 16, 8, 12),
     lambda: QM.splitk_plan(1, 4096, 4096, int8_weights=True)),
    ("int8_dyn_splitk", 16, 4096, 4096, (2, 8, 4, 32, 12),
     lambda: QM.splitk_plan(16, 4096, 4096, xbytes=1, int8_weights=True)),
    ("int4_mma", 128, 4096, 4096, (96, 1, 128, 32), lambda: QM.mma_plan(128, 4096, 4096)),
    ("int4_mma", 128, 4096, 4096, (128, 2, 63, 64), lambda: QM.mma_plan(128, 4096, 4096)),
    ("int8_mma", 512, 4096, 4096, (128, 3, 16, 132), lambda: QM.int8_mma_plan(512, 4096, 4096)),
    ("int4_t_mma", 1024, 4096, 512, (64, 1, 4, 0), lambda: QM.t_mma_plan(1024, 4096, 512)),
    ("int8_dyn_mma", 128, 4096, 512, (64, 8, 8, 16), lambda: D.dyn_plan(128, 4096, 512)),
])
def test_an_entry_the_kernel_refuses_raises_naming_its_key(table, kernel, bucket, K, N, plan,
                                                           call):
    name = AT.record(kernel, bucket, K, N, plan)
    with pytest.raises(ValueError, match=name.replace("|", r"\|")):
        call()


def test_an_entry_without_a_plan_list_or_a_broken_table_raises(table):
    table.write_text(json.dumps({AT.key("int4_mma", 128, 4096, 4096): {"bm": 64}}))
    AT.reload()
    with pytest.raises(ValueError, match="no plan list"):
        QM.mma_plan(128, 4096, 4096)
    table.write_text("{not json")
    AT.reload()
    with pytest.raises(ValueError, match="not JSON"):
        QM.mma_plan(128, 4096, 4096)


@pytest.mark.parametrize("M", [1, 4, 16, 36, 64])
def test_sweep_splitk_candidates_are_plans_the_kernels_take(M):
    for K, N in SHAPES:
        for (xb, i8), (_, max_mt) in QM.SPLITK_KERNELS.items():
            if M > 8 * max_mt:
                continue
            cands = S.splitk_candidates(M, K, N, xb, i8)
            assert cands[0] == QM.builtin_splitk_plan(M, K, N, xb, i8)
            assert len(cands) == len(set(cands)) >= 3
            for p in cands:
                assert QM.splitk_problem(M, K, N, p, xb, max_mt) is None, (M, K, N, p)
            rows = 8 * QM.splitk_mt(M)  # every other candidate fits its whole bucket
            for p in cands[1:]:
                assert QM.splitk_problem(rows, K, N, p, xb, max_mt) is None, (M, K, N, p)


@pytest.mark.parametrize("M", [65, 128, 512, 1024])
def test_sweep_hopper_candidates_are_plans_the_kernels_take(M):
    for K, N in SHAPES:
        for int4 in (True, False):
            cands = S.wg_candidates(M, K, N, int4)
            assert cands[0] == (QM.mma_plan(M, K, N) if int4 else QM.int8_mma_plan(M, K, N))
            assert len(cands) == len(set(cands)) >= 3
            for p in cands:
                ok = (QM.mma_problem(K, p) if int4
                      else QM.wg_problem(-(-K // QM.MMA_STEP), p))
                assert ok is None, (M, K, N, p)


def test_a_split_k_entry_recorded_at_m1_serves_its_whole_bucket(table):
    """An entry is keyed by its bucket (8 · m-tiles rows): a plan recorded
    for M = 1 is what M = 8 launches, and one whose shared memory fits M = 1
    but not M = 8 (w_out, one K split, 432 groups a chunk: 221 KB at M = 8)
    raises at every M of the bucket."""
    K, N = 13824, 4096
    fits = [p for p in S.splitk_candidates(1, K, N, 2, False)[1:]
            if p != QM.builtin_splitk_plan(8, K, N)]
    AT.record("int4_splitk", 8, K, N, fits[0])
    assert QM.splitk_plan(1, K, N) == QM.splitk_plan(8, K, N) == fits[0]
    wide = (1, 8, 1, 432, 432)
    assert QM.splitk_problem(1, K, N, wide) is None and QM.splitk_problem(8, K, N, wide)
    assert wide not in S.splitk_candidates(1, K, N, 2, False)[1:]
    name = AT.record("int4_splitk", 8, K, N, wide)
    for M in (1, 8):
        with pytest.raises(ValueError, match="shared bytes over") as e:
            QM.splitk_plan(M, K, N)
        assert name in str(e.value)


def test_the_sweep_refuses_two_ms_of_one_entry():
    assert S.table_entry("int4", 1) == S.table_entry("int4", 4) == ("int4_splitk", 8)
    assert S.table_entry("int4", 65) == S.table_entry("int4", 128) == ("int4_mma", 128)
    assert S.table_entry("int8", 16) == ("int8_splitk", 16)
    assert S.table_entry("int8", 17) == ("int8_mma", 64)
    for ms in ([1, 4, 128], [1, 65, 128]):
        with pytest.raises(ValueError, match="sweep one of them"):
            S.sweep("int4", ["q_proj"], ms)


def test_sweep_needs_the_card():
    with pytest.raises(SystemExit, match="CUDA is not available"):
        S.main(["--kernel", "int4", "--m", "1"])
