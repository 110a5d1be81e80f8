"""VQA task builders (reference data_gen/vqa_task_construction.py:155-350,
511-615) — each returns a ``{"image", "conversations"}`` record in the
byte-compatible string formats of codecs.triad."""

from __future__ import annotations

import random
import numpy as np

from a3vlm_tpu_torch.codecs import vocab as V
from a3vlm_tpu_torch.codecs.triad import (
    det_all_3d_answer,
    det_all_rotated_answer,
    format_axis_3d,
    format_bbox_3d,
    format_depth_ext,
    format_joint_answer,
    format_rotated_box,
    vqa_record,
)

# ---------------------------------------------------------------------------
# 2D tasks
# ---------------------------------------------------------------------------


def create_single_link_rec_rotated_task(link_name, rot_box, img_path):
    question = V.REC_SINGLE_LINK_INSTRUCT + link_name
    return vqa_record(img_path, question, format_rotated_box(rot_box))


def create_det_all_rotated_task(link_info_list, img_path, max_det=10):
    return vqa_record(
        img_path,
        V.DET_ALL_ROT_INSTRUCT,
        det_all_rotated_answer(link_info_list, max_det=max_det),
    )


def _link_ref(link_info) -> str:
    return (
        link_info
        if isinstance(link_info, str)
        else format_rotated_box(link_info)
    )


def create_rec_joint_rotated_task(link_info, rot_box, joint_type, img_path):
    question = V.REC_JOINT_ROT_INSTRUCT.format(REF=_link_ref(link_info))
    answer = format_joint_answer(joint_type, format_rotated_box(rot_box))
    return vqa_record(img_path, question, answer)


def create_rec_joint_rotated_ext_task(
    link_info, rot_box_ext, joint_type, img_path
):
    question = V.REC_JOINT_ROT_EXT_INSTRUCT.format(REF=_link_ref(link_info))
    answer = format_joint_answer(
        joint_type, format_rotated_box(rot_box_ext, with_depth=True)
    )
    return vqa_record(img_path, question, answer)


def create_rec_joint_rotated_ext_task_with_sep_depth(
    link_info, rot_box_ext, joint_type, img_path
):
    question = V.REC_JOINT_ROT_EXT_INSTRUCT.format(REF=_link_ref(link_info))
    answer = (
        format_joint_answer(joint_type, format_rotated_box(rot_box_ext))
        + V.DELIM_RBD_START
        + format_depth_ext(rot_box_ext[-2], rot_box_ext[-1])
        + V.DELIM_RBD_END
    )
    return vqa_record(img_path, question, answer)


def create_reg_status_qa_task(link_info, closed, img_path):
    # NOTE(reference quirk): the status question reuses the joint-REC
    # instruction, not REG_STATUS_INSTRUCT (vqa_task_construction.py:270-275)
    question = V.REC_JOINT_ROT_INSTRUCT.format(REF=_link_ref(link_info))
    return vqa_record(img_path, question, "Closed" if closed else "Opened")


# ---------------------------------------------------------------------------
# grounding
# ---------------------------------------------------------------------------


def replace_link_with_bbox(
    actions, link_info_list, indexing="bounding_box", anno_meta=None,
    normalize=False, use_eight_points=False,
):
    """(vqa_task_construction.py:294-323)"""
    if indexing in ("bounding_box", "bbox"):
        link_bbox_map = {
            link["link_name_status"]: format_rotated_box(link["bbox"])
            for link in link_info_list
        }
    elif indexing == "bbox_3d":
        link_bbox_map = {
            link["link_name_status"]: format_bbox_3d(
                link["bbox_3d"], anno_meta=anno_meta, normalize=normalize,
                use_eight_points=use_eight_points,
            )
            for link in link_info_list
        }
    else:
        raise ValueError(indexing)

    action_str = ""
    for action_index, action in enumerate(actions):
        for link_name, bbox in link_bbox_map.items():
            if link_name in action:
                if "StatusComplete" in action:
                    action_str += "StatusComplete"
                    break
                action_type = action.split("[")[0]
                if indexing == "bbox_3d":
                    action_str += (
                        V.DELIM_BOX_START + action_type + V.DELIM_BOX_END + bbox
                    )
                else:
                    action_str += (
                        V.DELIM_RB_START + action_type + V.DELIM_RB_END + bbox
                    )
                if action_index != len(actions) - 1:
                    action_str += ","
                break
            elif "StatusComplete" in action:
                action_str += "StatusComplete"
                break
    return action_str


def select_random_task(
    categories, link_info_list, indexing="bounding_box", anno_meta=None,
    normalize=False, use_eight_points=False, rng=None,
):
    rng = rng or random
    category = rng.choice(list(categories.keys()))
    task_name = rng.choice(list(categories[category].keys()))
    task = categories[category][task_name]
    actions = replace_link_with_bbox(
        task["actions"], link_info_list, indexing, anno_meta=anno_meta,
        normalize=normalize, use_eight_points=use_eight_points,
    )
    return task["description"], actions


def _grounding(
    possible_tasks, link_info_list, path, indexing, instruct, anno_meta=None,
    normalize=False, use_eight_points=False,
):
    if not possible_tasks:
        return None
    for _ in range(2):  # one retry (vqa_task_construction.py:332-337)
        description, actions = select_random_task(
            possible_tasks, link_info_list, indexing, anno_meta=anno_meta,
            normalize=normalize, use_eight_points=use_eight_points,
        )
        if len(actions) >= 5:
            return vqa_record(path, instruct + description, actions)
    return None


def create_grounding_task(
    possible_tasks, link_info_list, img_path, indexing="bounding_box",
    anno_meta=None, normalize=False, use_eight_points=False,
):
    return _grounding(
        possible_tasks, link_info_list, img_path, indexing,
        V.GROUNDING_ACTIONS_INSTRUCT, anno_meta, normalize, use_eight_points,
    )


def create_3d_grounding_task(
    possible_tasks, link_info_list, pcd_path, indexing="bbox_3d",
    anno_meta=None, normalize=False, use_eight_points=False,
):
    return _grounding(
        possible_tasks, link_info_list, pcd_path, indexing,
        V.GROUNDING_ACTIONS_3D_INSTRUCT, anno_meta, normalize,
        use_eight_points,
    )


# ---------------------------------------------------------------------------
# 3D tasks
# ---------------------------------------------------------------------------


def _link_ref_3d(link_info_3d, anno_meta, normalize, use_eight_points):
    if isinstance(link_info_3d, str):
        return link_info_3d
    return format_bbox_3d(
        link_info_3d, anno_meta=anno_meta, normalize=normalize,
        use_eight_points=use_eight_points,
    )


def create_single_link_3d_rec_task(
    link_name, bbox_3d, pcd_path, anno_meta=None, normalize=False,
    use_eight_points=False,
):
    question = V.REC_SINGLE_LINK_3D_INSTRUCT + link_name
    answer = format_bbox_3d(
        bbox_3d, anno_meta=anno_meta, normalize=normalize,
        use_eight_points=use_eight_points,
    )
    return vqa_record(pcd_path, question, answer)


def create_3d_rec_joint_task(
    link_info_3d, axis_3d, joint_type, pcd_path, anno_meta=None,
    normalize=False, use_eight_points=False, axis_3d_proj=None,
):
    question = V.REC_JOINT_3D_INSTRUCT.format(
        REF=_link_ref_3d(link_info_3d, anno_meta, normalize, use_eight_points)
    )
    if axis_3d_proj is None:
        axis_str = format_axis_3d(
            np.asarray(axis_3d), anno_meta, normalize=normalize
        )
    else:
        axis_str = "[{:.2f},{:.2f}]".format(*axis_3d_proj)
    answer = V.DELIM_AXIS_START + joint_type + V.DELIM_AXIS_END + axis_str
    return vqa_record(pcd_path, question, answer)


def create_3d_reg_status_qa_task(
    link_info, closed, pcd_path, anno_meta=None, normalize=False,
    use_eight_points=False,
):
    question = V.REC_JOINT_3D_INSTRUCT.format(
        REF=_link_ref_3d(link_info, anno_meta, normalize, use_eight_points)
    )
    return vqa_record(pcd_path, question, "Closed" if closed else "Opened")


def create_det_all_bbox_3d_task(
    link_info_list, pcd_path, max_det=10, anno_meta=None, normalize=False,
    use_eight_points=False,
):
    return vqa_record(
        pcd_path,
        V.DET_ALL_BBOX_3D_INSTRUCT,
        det_all_3d_answer(
            link_info_list, anno_meta=anno_meta, normalize=normalize,
            use_eight_points=use_eight_points, max_det=max_det,
        ),
    )
