"""Grounding-task bank generation (reference data_gen/
openai_grounding_tasks.py + openai_description.py):

- ``link_semantics_from_urdf``: link semantics (+open/closed variants) from
  semantics.txt + the URDF (openai_grounding_tasks.py:17-60).
- ``generate_template_tasks``: an OFFLINE template-based generator producing
  the same bank schema the GPT-4 prompt asks for ({category: {task_name:
  {description, actions}}}) using the action-primitive vocabulary — this
  replaces the network-bound GPT-4 call in zero-egress environments.
- ``generate_openai_tasks``: the API-backed path, gated on the optional
  ``openai`` package + key (kept for parity; same output schema).

Banks are saved keyed ``{Category}_{joint}_{link}_...json`` so the labeler's
loader (datagen/labeler._load_grounding_tasks) finds them.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from a3vlm_tpu_torch.codecs.vocab import JOINT_TYPES_MAPPING


def link_semantics_from_urdf(semantics_file: str, urdf_file: str,
                             open_close_parts=None):
    """[(link_name, joint_type, semantic, has_status), ...]"""
    from a3vlm_tpu_torch.datagen.urdf import URDF

    out = []
    robot = URDF.load(urdf_file)
    actuated_children = {j.child for j in robot.actuated_joints}
    with open(semantics_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) != 3:
                continue
            link_name, joint_type, semantic = parts
            has_status = bool(
                open_close_parts and semantic in open_close_parts
            ) and link_name in actuated_children
            out.append((link_name, joint_type, semantic, has_status))
    return out


# joint-type -> plausible action primitives for template generation
_ACTIONS_BY_JOINT = {
    "hinge": ["flap_open", "flap_close", "rotate"],
    "slider": ["slide_open", "slide_close", "slide_in", "slide_out"],
    "slider+": ["slide_open", "slide_close"],
    "free": ["pick", "place", "rotate"],
}

_TASK_TEMPLATES = [
    ("open_task", "Open the {semantic} of the {category}.",
     ["{open_action}[{ref}]", "StatusComplete"]),
    ("close_task", "Close the {semantic} of the {category}.",
     ["{close_action}[{ref}]", "StatusComplete"]),
    ("inspect_task", "Check inside the {category} by operating its "
     "{semantic}.",
     ["{open_action}[{ref}]", "{close_action}[{ref}]", "StatusComplete"]),
    ("wipe_task", "Clean the {semantic} of the {category}.",
     ["wipe[{ref}]", "StatusComplete"]),
]


def generate_template_tasks(category: str, link_semantics) -> dict:
    """{category: {task_name: {description, actions}}} using
    status-qualified link references (the actions mention
    ``{status}_{semantic}`` names the labeler substitutes boxes for)."""
    tasks: dict = {}
    for link_name, joint_type, semantic, has_status in link_semantics:
        if joint_type not in ("hinge", "slider", "slider+"):
            continue
        acts = _ACTIONS_BY_JOINT.get(joint_type, ["press"])
        open_action = acts[0]
        close_action = acts[1] if len(acts) > 1 else acts[0]
        refs = (
            [f"closed_{semantic}", f"opened_{semantic}"]
            if has_status
            else [semantic]
        )
        for ref in refs:
            for name, desc, action_tpl in _TASK_TEMPLATES:
                task_name = f"{name}_{ref}"
                tasks[task_name] = {
                    "description": desc.format(
                        semantic=semantic, category=category
                    ),
                    "actions": [
                        a.format(
                            ref=ref, open_action=open_action,
                            close_action=close_action,
                        )
                        for a in action_tpl
                    ],
                }
    return {category: tasks}


def bank_filename(category: str, link_semantics) -> str:
    """Matches the labeler's ``{Category}_{joint}_{link}_...json`` key."""
    names = []
    for _, joint_type, semantic, _ in link_semantics:
        s = f"{JOINT_TYPES_MAPPING[joint_type]}_{semantic}"
        if s not in names:
            names.append(s)
    idx = "".join(n + "_" for n in sorted(set(names)))
    return f"{category}_{idx}.json"


def generate_bank_for_object(
    data_dir: str, data_name: str, out_folder: str,
    category: Optional[str] = None,
) -> Optional[str]:
    from a3vlm_tpu_torch.codecs.vocab import OPEN_CLOSE_STATUS

    obj = os.path.join(data_dir, data_name)
    semantics = os.path.join(obj, "semantics.txt")
    urdf = os.path.join(obj, "mobility.urdf")
    if not (os.path.isfile(semantics) and os.path.isfile(urdf)):
        return None
    if category is None:
        meta = os.path.join(obj, "meta.json")
        with open(meta) as f:
            category = json.load(f).get("model_cat", "Unknown")
    links = link_semantics_from_urdf(
        semantics, urdf, OPEN_CLOSE_STATUS.get(category)
    )
    bank = generate_template_tasks(category, links)
    if not bank[category]:
        return None
    os.makedirs(out_folder, exist_ok=True)
    path = os.path.join(out_folder, bank_filename(category, links))
    # merge with an existing bank (history merge, openai_grounding_tasks
    # .py:63-151)
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
        existing.setdefault(category, {}).update(bank[category])
        bank = existing
    with open(path, "w") as f:
        json.dump(bank, f, indent=2)
    return path


# The full GPT-4 prompt is a DATA CONTRACT shipped verbatim
# (prompts/grounding_task_generation.txt — the reference's
# data_gen/prompts/grounding_task_generation.txt: skill library, the 10
# generation constraints, and both worked examples). Substitution is
# str.replace on the three {PLACEHOLDER}s, so the template's literal
# JSON braces survive (the reference formats the same way,
# openai_grounding_tasks.py:104-151).
with open(
    os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "prompts", "grounding_task_generation.txt",
    )
) as _f:
    DEFAULT_PROMPT = _f.read()

_SYSTEM_MSG = (
    "You are a good assistant, skilled in creating a grounding training "
    "dataset for the given daily-use furniture class. Provide output in "
    "valid JSON."
)


def _strip_json_fences(text: str) -> str:
    """The reference's response cleanup (openai_grounding_tasks.py:140)."""
    return (
        text.split("```json")[-1].split("```")[0]
        .replace("```json", "").replace("```", "").strip().rstrip()
    )


def generate_openai_tasks(
    data_dir: str,
    data_name: str,
    out_folder: str,
    client=None,
    prompt: str = DEFAULT_PROMPT,
    max_tasks: int = 20,
    failure_folder: Optional[str] = None,
) -> str:
    """GPT-4-backed bank generation (openai_grounding_tasks.py:104-151):
    builds the {OBJECT_CLASS}/{LINK_INFO}/{HISTORY_GENERATION}-substituted
    prompt, calls the model, strips ```json fences, parses, and
    history-merges into the same ``{Category}_{idx}.json`` bank the offline
    generator writes. Returns "SKIP" | "Success" | "Fail".

    ``client``: injectable ``callable(system_msg, user_msg) -> str`` (the
    chat-completion content). When None, the real OpenAI client is built
    (optional dependency + OPENAI_API_KEY); the surrounding loop, prompt
    substitution, fence-stripping, history merge, and failure capture are
    covered by tests with a stub client."""
    if client is None:  # pragma: no cover - requires openai + network
        import os as _os

        from openai import OpenAI

        api_key = _os.getenv("OPENAI_API_KEY")
        assert api_key is not None, "set OPENAI_API_KEY first"
        _oai = OpenAI(api_key=api_key)

        def client(system_msg, user_msg):
            completion = _oai.chat.completions.create(
                model="gpt-4",
                messages=[
                    {"role": "system", "content": system_msg},
                    {"role": "user", "content": user_msg},
                ],
            )
            return completion.choices[0].message.content

    from a3vlm_tpu_torch.codecs.vocab import OPEN_CLOSE_STATUS

    obj = os.path.join(data_dir, data_name)
    meta_json = os.path.join(obj, "meta.json")
    if not (
        os.path.exists(meta_json)
        and os.path.isfile(os.path.join(obj, "semantics.txt"))
        and os.path.isfile(os.path.join(obj, "mobility.urdf"))
    ):
        return "SKIP"
    with open(meta_json) as f:
        category = json.load(f).get("model_cat", "Unknown")
    links = link_semantics_from_urdf(
        os.path.join(obj, "semantics.txt"),
        os.path.join(obj, "mobility.urdf"),
        OPEN_CLOSE_STATUS.get(category),
    )
    link_info = [
        {
            "name": (f"opened_{sem}" if has_status else sem),
            "joint_type": jt,
            "status": "open/close" if has_status else "N.A.",
        }
        for _, jt, sem, has_status in links
    ]
    os.makedirs(out_folder, exist_ok=True)
    path = os.path.join(out_folder, bank_filename(category, links))
    history: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            history = json.load(f)
        if sum(len(t) for t in history.values()) >= max_tasks:
            return "SKIP"

    user_msg = (
        prompt.replace("{OBJECT_CLASS}", category)
        .replace("{LINK_INFO}", str(link_info))
        .replace("{HISTORY_GENERATION}", str(history))
    )
    response = _strip_json_fences(client(_SYSTEM_MSG, user_msg))
    try:
        result = json.loads(response)
    except Exception:
        fail_dir = failure_folder or os.path.join(out_folder, "failures")
        os.makedirs(fail_dir, exist_ok=True)
        with open(
            os.path.join(fail_dir, bank_filename(category, links) + ".txt"),
            "w",
        ) as f:
            f.write(response)
        return "Fail"
    # history merge: keep every already-generated task the response omits
    # (save_history_generated, openai_grounding_tasks.py:78-101)
    merged = dict(result)
    merged.setdefault(category, {})
    for cat, tasks in history.items():
        merged.setdefault(cat, {})
        for name, task in tasks.items():
            merged[cat].setdefault(name, task)
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)
    return "Success"


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("generate grounding task banks (offline)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_folder", default="./grounding_tasks")
    p.add_argument("--data_name", default="all")
    args = p.parse_args(argv)
    names = (
        [args.data_name]
        if args.data_name != "all"
        else sorted(
            d
            for d in os.listdir(args.data_dir)
            if os.path.isdir(os.path.join(args.data_dir, d))
        )
    )
    n = 0
    for name in names:
        if generate_bank_for_object(args.data_dir, name, args.out_folder):
            n += 1
    print(f"generated banks for {n}/{len(names)} objects")


if __name__ == "__main__":
    main()
