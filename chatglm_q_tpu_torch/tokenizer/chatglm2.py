"""ChatGLM2 tokenizer: sentencepiece model + 5 appended special tokens.

A copy of chatglm_q_tpu/tokenizer/chatglm2.py, with PyTorch tensors in
place of jax arrays.  Behavioral re-creation of the reference's
chatglm_q/tokenizer.py:25-144 on
top of the self-contained SpTokenizer core (no ``sentencepiece`` runtime
dependency): the specials ``[MASK] [gMASK] [sMASK] <sop> <eop>`` get ids
after the sp vocab, ``encode`` prepends ``[gMASK] <sop>`` and appends
``</s>`` after a text pair, ``decode`` drops ids ≥ the sp vocab size, and
the batch ``__call__`` supports left (default) / right padding, truncation,
numpy/PyTorch tensors, and −100-masked labels.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Literal, Union

import numpy as np

from .sp_core import SpTokenizer


class BatchEncoding(dict):
    """dict with attribute access (tokenizer.py:8-22); arrays are lists,
    numpy arrays or CPU tensors (move them with ``.to(device)``)."""

    def __getattr__(self, item: str):
        try:
            return self[item]
        except KeyError:
            raise AttributeError(item)

    def __setattr__(self, item: str, value: Any):
        self[item] = value


class ChatGLM2Tokenizer:
    def __init__(self, vocab_file: Union[str, Path, bytes]):
        assert vocab_file is not None
        self.vocab_file = vocab_file
        self.special_tokens = ["[MASK]", "[gMASK]", "[sMASK]", "<sop>", "<eop>"]
        self.text_tokenizer = SpTokenizer(vocab_file)
        self.vocab_size = len(self.text_tokenizer) + len(self.special_tokens)
        self.true_vocab_size = len(self.text_tokenizer)

        self.bos_id: int = self.text_tokenizer.bos_id()
        self.eos_id: int = self.text_tokenizer.eos_id()
        self.pad_id: int = self.text_tokenizer.unk_id()

    def __len__(self):
        return self.vocab_size

    def __getitem__(self, key: str) -> int:
        if key in self.special_tokens:
            return self.true_vocab_size + self.special_tokens.index(key)
        return self.text_tokenizer[key]

    def encode(self, text: str, text_pair: str = None, add_special_tokens=True) -> list[int]:
        """[gMASK] <sop> prefix; </s> after text_pair (tokenizer.py:46-64)."""
        tokens = self.text_tokenizer.encode(text)
        if add_special_tokens:
            tokens = [self["[gMASK]"], self["<sop>"]] + tokens
        if text_pair is not None:
            tokens += self.text_tokenizer.encode(text_pair)
            if add_special_tokens:
                tokens += [self.eos_id]
        return tokens

    def decode(self, text_ids: list[int]) -> str:
        text_ids = [x for x in text_ids if x < self.true_vocab_size]
        return self.text_tokenizer.decode(text_ids)

    def __call__(
        self,
        text: Union[str, list[str]],
        text_pair: Union[str, list[str]] = None,
        add_special_tokens=True,
        padding: Literal[True, False, "left", "right"] = False,
        max_length: int = None,
        return_tensors: Literal[False, "np", "pt"] = False,
        return_labels=False,
    ) -> BatchEncoding:
        """Batch-encode with padding (default left, as the decode-time layout
        requires) — behavior matches tokenizer.py:66-144; implementation is a
        vectorized mask/scatter over a dense (batch, width) grid."""
        texts = [text] if isinstance(text, str) else list(text)
        if text_pair is None:
            pairs = [None] * len(texts)
        else:
            pairs = [text_pair] if isinstance(text_pair, str) else list(text_pair)
        assert len(texts) == len(pairs)

        seqs = [self.encode(t, p, add_special_tokens) for t, p in zip(texts, pairs)]
        if max_length:
            seqs = [ids[:max_length] for ids in seqs]

        if padding is False:
            assert not return_tensors, "set padding=True when return_tensors"
            return BatchEncoding(
                input_ids=seqs,
                attention_mask=[[1] * len(ids) for ids in seqs],
                position_ids=[list(range(len(ids))) for ids in seqs],
            )

        lengths = np.array([len(ids) for ids in seqs], dtype=np.int64)
        width = int(lengths.max()) if len(seqs) else 0
        grid = np.arange(width, dtype=np.int64)[None, :]
        if padding == "right":
            valid = grid < lengths[:, None]
        else:  # "left" / True
            valid = grid >= (width - lengths)[:, None]
        # valid slots are contiguous per row, so a row-major boolean scatter
        # of the concatenated ids lands each sequence in order
        input_ids = np.full((len(seqs), width), self.pad_id, dtype=np.int64)
        if seqs:
            input_ids[valid] = np.concatenate(
                [np.asarray(ids, dtype=np.int64) for ids in seqs]
            )
        attention_mask = valid.astype(np.int64)
        position_ids = np.where(valid, np.cumsum(valid, axis=1) - 1, 0)

        arrays = dict(input_ids=input_ids, attention_mask=attention_mask,
                      position_ids=position_ids)
        if return_labels:
            assert return_tensors, "'return_labels' requires return_tensors"
            arrays["labels"] = np.where(valid, input_ids, -100)
        if not return_tensors:
            arrays = {k: v.tolist() for k, v in arrays.items()}
        elif return_tensors == "pt":
            import torch

            arrays = {k: torch.from_numpy(v) for k, v in arrays.items()}
        return BatchEncoding(**arrays)
