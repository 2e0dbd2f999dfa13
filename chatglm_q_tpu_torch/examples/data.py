"""Calibration / evaluation text: the port's copy of
examples/evaluations/data.py.

The reference pulls C-Eval with ``datasets.load_dataset`` (a network
fetch).  Here: a local C-Eval copy when given, else a user text file, else a
deterministic synthetic corpus (marked as such), so the pipelines run
offline.  Nothing is fetched.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Optional


def load_ceval_val(ceval_dir: str, subjects: Optional[list[str]] = None) -> list[dict]:
    """Read C-Eval val rows from a local download (jsonl or json per subject)."""
    rows = []
    root = Path(ceval_dir)
    for f in sorted(root.rglob("*val*")):
        if f.suffix in (".jsonl", ".json"):
            text = f.read_text()
            try:
                data = json.loads(text)
                if isinstance(data, dict):
                    data = list(data.values())
            except json.JSONDecodeError:
                data = [json.loads(line) for line in text.splitlines() if line.strip()]
            for r in data:
                if isinstance(r, dict):
                    r.setdefault("subject", f.stem.replace("_val", ""))
                    rows.append(r)
    return rows


def ceval_question_text(row: dict) -> str:
    """The reference's calibration prompt format: question + answer text
    (quantize_gptq/int4g32.py:20-24)."""
    q = row.get("question", "")
    choices = "".join(
        f"\n{c}. {row[c]}" for c in ("A", "B", "C", "D") if c in row
    )
    ans = row.get("answer", "")
    return f"{q}{choices}\n答案：{ans}"


_SYNTH_TOPICS = [
    "机器学习模型的训练过程包括前向传播和反向传播两个阶段",
    "The transformer architecture relies on attention mechanisms",
    "量子计算机利用量子比特的叠加态进行并行计算",
    "Photosynthesis converts light energy into chemical energy",
    "微积分中的导数描述函数在某一点的变化率",
    "The French Revolution began in 1789 and reshaped Europe",
    "蛋白质由氨基酸通过肽键连接而成",
    "Supply and demand determine prices in a market economy",
]


def synthetic_texts(n: int, seed: int) -> list[str]:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        parts = rng.sample(_SYNTH_TOPICS, k=3)
        out.append("问：" + "。".join(parts) + f"。请解释第{i % 4 + 1}点。\n答：")
    return out


def load_calibration_texts(
    calib_file: Optional[str] = None,
    ceval_dir: Optional[str] = None,
    num_prompts: int = 200,
    seed: int = 42,
) -> list[str]:
    if calib_file:
        texts = [l for l in Path(calib_file).read_text().splitlines() if l.strip()]
    elif ceval_dir:
        rows = load_ceval_val(ceval_dir)
        texts = [ceval_question_text(r) for r in rows]
    else:
        print("WARNING: no calibration source given; using synthetic corpus "
              "(pass --ceval-dir or --calib-file for reference-parity calibration)")
        texts = synthetic_texts(max(num_prompts * 2, 400), seed)
    random.Random(seed).shuffle(texts)
    return texts[:num_prompts]
