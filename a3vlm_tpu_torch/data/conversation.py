"""Conversation templating (reference model/accessory/data/conversation/
lib.py): builds "###Human/###Assistant"-style transcripts plus the list of
assistant spans the model must learn to predict."""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None

    def process(self) -> dict:
        """Returns {"conv": transcript, "to_predict": [assistant spans]}
        (lib.py:25-61). A None message must be last and leaves the prompt
        open for generation."""
        to_predict = []
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + "\n\n" + self.sep
            for i, (role, message) in enumerate(self.messages):
                if message is not None:
                    ret += " " + role + ": " + message + "\n" + self.sep
                    if role == self.roles[1]:
                        to_predict.append(message + "\n" + self.sep)
                else:
                    assert i == len(self.messages) - 1, (
                        "only last message can be None"
                    )
                    ret += " " + role + ":"
        elif self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += " " + role + ": " + message + seps[i % 2]
                    if role == self.roles[1]:
                        to_predict.append(message + seps[i % 2])
                else:
                    assert i == len(self.messages) - 1, (
                        "only last message can be None"
                    )
                    ret += " " + role + ":"
        else:  # pragma: no cover
            raise ValueError(f"invalid style: {self.sep_style}")
        return {"conv": ret, "to_predict": to_predict}

    def get_prompt(self) -> str:
        return self.process()["conv"]

    def append_message(self, role, message):
        self.messages.append([role, message])

    def load_qas(self, qas: List[List[Optional[str]]]) -> None:
        """(lib.py:78-90) — last answer None leaves an open prompt."""
        self.messages = []
        for q, a in qas:
            self.append_message(self.roles[0], q)
            self.append_message(self.roles[1], a)

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[x, y] for x, y in self.messages],
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
        )

    @property
    def response_end_signal(self) -> str:
        return (
            "\n" + self.sep
            if self.sep_style == SeparatorStyle.SINGLE
            else self.sep2
        )


def conv_v1_2() -> Conversation:
    """The default template (lib.py:110-119,190)."""
    return Conversation(
        system=(
            "A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."
        ),
        roles=("Human", "Assistant"),
        messages=[],
        sep_style=SeparatorStyle.SINGLE,
        sep="###",
    )


def conv_vicuna_v1_1() -> Conversation:
    return Conversation(
        system=(
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        ),
        roles=("USER", "ASSISTANT"),
        messages=[],
        sep_style=SeparatorStyle.TWO,
        sep=" ",
        sep2="</s>",
    )


def conv_bair_v1() -> Conversation:
    return Conversation(
        system="BEGINNING OF CONVERSATION:",
        roles=("USER", "GPT"),
        messages=[],
        sep_style=SeparatorStyle.TWO,
        sep=" ",
        sep2="</s>",
    )


def simple_conv_multimodal() -> Conversation:
    return Conversation(
        system=(
            "You are LLaVA, a large language and vision assistant trained by "
            "UW Madison WAIV Lab.You are able to understand the visual "
            "content that the user provides, and assist the user with a "
            "variety of tasks using natural language.Follow the instructions "
            "carefully and explain your answers in detail."
        ),
        roles=("Human", "Assistant"),
        messages=[],
        sep_style=SeparatorStyle.SINGLE,
        sep="###",
    )


def conv_llava_v1() -> Conversation:
    return Conversation(
        system=(
            "You are LLaVA, a large language and vision assistant trained by "
            "UW Madison WAIV Lab.You are able to understand the visual "
            "content that the user provides, and assist the user with a "
            "variety of tasks using natural language.Follow the instructions "
            "carefully and explain your answers in detail."
        ),
        roles=("USER", "ASSISTANT"),
        messages=[],
        sep_style=SeparatorStyle.TWO,
        sep=" ",
        sep2="</s>",
    )


default_conversation = conv_v1_2
conv_templates = {
    "default": conv_v1_2,
    "simple": conv_v1_2,
    "multimodal": simple_conv_multimodal,
    "llava_v1": conv_llava_v1,
    "v1": conv_v1_2,
    "bair_v1": conv_bair_v1,
    "vicuna_v1_1": conv_vicuna_v1_1,
}


class ConversationGenerator:
    """(conversation/dataset.py:32-64)"""

    def __init__(self, tokenizer, conv_template_func=default_conversation):
        self.tokenizer = tokenizer
        self.conv_func = conv_template_func

    def add_speaker_and_signal(self, source: List[dict]):
        conv = self.conv_func()
        for sentence in source:
            from_str = sentence["from"].lower()
            if from_str in ("human",):
                role = conv.roles[0]
            elif from_str in ("gpt", "assistant"):
                role = conv.roles[1]
            else:
                raise ValueError(f"unknown dialog role: {from_str}")
            conv.append_message(role, sentence["value"])
        processed = conv.process()
        return processed["conv"], processed["to_predict"]
