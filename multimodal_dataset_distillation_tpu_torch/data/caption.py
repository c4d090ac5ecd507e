"""Caption preprocessing — byte-identical to the reference.

The port's own copy of ``multimodal_dataset_distillation_tpu/data/caption.py``.

Reference: ``pre_caption`` (``data/flickr30k_dataset.py:16-35``):
lowercase, replace ``[.!"()*#:;~]`` with space, collapse multiple
whitespace to one space, strip trailing newline and surrounding spaces,
truncate to ``max_words`` (30 on all VL paths).
"""

from __future__ import annotations

import re


def pre_caption(caption: str, max_words: int = 50) -> str:
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n")
    caption = caption.strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption


def pre_question(question: str, max_ques_words: int = 50) -> str:
    """utils.py pre_question parity (punct removed, not spaced)."""
    question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
    question = question.rstrip(" ")
    words = question.split(" ")
    if len(words) > max_ques_words:
        question = " ".join(words[:max_ques_words])
    return question
