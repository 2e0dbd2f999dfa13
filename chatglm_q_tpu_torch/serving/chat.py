"""ChatGLM2 chat prompt formatting and response post-processing.

Behavioral re-creation of the reference's chatglm_q/decoder.py:111-134; a
copy of chatglm_q_tpu/serving/chat.py.
"""
from __future__ import annotations

import re


def chat_template(history: list[tuple[str, str]], current: str) -> str:
    """[Round n] 问/答 prompt format (decoder.py:111-118)."""
    prompt = ""
    chat_round = 1
    for question, answer in history:
        prompt += f"[Round {chat_round}]\n\n问：{question}\n\n答：{answer}\n\n"
        chat_round += 1
    prompt += f"[Round {chat_round}]\n\n问：{current}\n\n答："
    return prompt


def process_response(response: str) -> str:
    """Strip, fix the training-time placeholder, and convert halfwidth
    punctuation to fullwidth when adjacent to CJK (decoder.py:121-134)."""
    response = response.strip()
    response = response.replace("[[训练时间]]", "2023年")
    punkts = [
        [",", "，"],
        ["!", "！"],
        [":", "："],
        [";", "；"],
        ["\\?", "？"],
    ]
    for item in punkts:
        response = re.sub(r"([一-鿿])%s" % item[0], r"\1%s" % item[1], response)
        response = re.sub(r"%s([一-鿿])" % item[0], r"%s\1" % item[1], response)
    return response
