"""System prompt formats (reference model/accessory/data/system_prompt.py)."""

from __future__ import annotations

from typing import Dict

_ALPACA_INPUT = (
    "Below is an instruction that describes a task, paired with an input "
    "that provides further context. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{instruction}\n\n### Input:\n{input}\n\n### Response:"
)
_ALPACA_NO_INPUT = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{instruction}\n\n### Response:"
)
_SHORTQA = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request using a "
    "single word or phrase.\n\n"
    "### Instruction:\n{instruction}\n\n### Response:"
)
_QG = "Generate a question whose answer is:\n{instruction}\n\nQuestion:\n"


def format_prompt(format_dict: Dict, sys_name: str = "alpaca") -> str:
    if sys_name == "alpaca":
        inp = format_dict.get("input")
        if inp is None or inp == "" or (isinstance(inp, str) and inp.isspace()):
            return _ALPACA_NO_INPUT.format_map(format_dict)
        return _ALPACA_INPUT.format_map(format_dict)
    if sys_name == "shortqa":
        return _SHORTQA.format_map(format_dict)
    if sys_name == "qg":
        return _QG.format_map(format_dict)
    if sys_name == "caption":
        return ""
    if sys_name == "None":
        return "{instruction}".format_map(format_dict)
    raise ValueError(sys_name)
