"""The PartNet labeler producing the training task streams (reference
data_gen/partnet_label.py): per image x link (visible: area > threshold and
vis_ratio > 0.2), builds the 2D axis rotated-bbox (axis-2D-span length,
height min(w,10)px, 5deg-quantized angle), the 2.5D depth extension, the
camera-frame 3D triad, open/closed status, and emits the 12 VQA task streams
(2D: single_link_rec, all_parts_det, joint_rec, joint_rec_ext,
joint_rec_sep_depth, status_reg, grounding; 3D: single_link_3d_rec,
all_parts_3d_det, joint_3d_rec, status_3d_reg, grounding_3d)."""

from __future__ import annotations

import copy
import json
import os
import random
from typing import Optional

import numpy as np

from a3vlm_tpu_torch.codecs import vqa_tasks as T
from a3vlm_tpu_torch.codecs.geometry import BBox3D, normalize_and_round_angle
from a3vlm_tpu_torch.codecs.vocab import (
    HOLDOUT_CLASSES,
    JOINT_TYPES_MAPPING,
    OPEN_CLOSE_STATUS,
)

TASK_STREAMS = [
    "single_link_rec_tasks",
    "all_parts_det_tasks",
    "joint_rec_tasks",
    "status_joint_reg_tasks",
    "grounding_tasks",
    "joint_rec_ext_tasks",
    "joint_rec_sep_depth_tasks",
    "single_link_3d_rec_tasks",
    "all_parts_3d_det_tasks",
    "joint_3d_rec_tasks",
    "status_joint_3d_reg_tasks",
    "grounding_3d_tasks",
]


class PartNetLabeler:
    def __init__(self, grounding_dataset_folder: Optional[str] = None):
        self.grounding_dataset_folder = grounding_dataset_folder
        self.vqa_tasks = {k: [] for k in TASK_STREAMS}
        self.link_dict: dict = {}
        self.img_link_anno_dict: dict = {}

    # -- loading -------------------------------------------------------------

    def read_info(
        self, joint_info_file, info_file, coco_annotation_file,
        annotation_3d_file, semantic_file,
    ):
        with open(joint_info_file) as f:
            self.joint_info = json.load(f)
        self.joint_info = [
            j for j in self.joint_info if j["joint"] != "junk"
        ]
        self.semantic_data = self._parse_semantic_file(semantic_file)
        self.num_links = len(self.semantic_data)
        self._parse_joint_info()
        with open(info_file) as f:
            self.info = json.load(f)
        self.cam_info = self.info["camera_info"]
        with open(coco_annotation_file) as f:
            self.annotations = json.load(f)
        with open(annotation_3d_file) as f:
            self.annotations_3d = json.load(f)
        self._build_coco_annotation_dict()
        self.object_cato = self.info.get("model_cat", "Unknown")
        self.opened_closed_status_parts = OPEN_CLOSE_STATUS.get(
            self.object_cato
        )
        self.grounding_tasks = self._load_grounding_tasks()

    @staticmethod
    def _parse_semantic_file(path):
        out = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) == 3:
                    out.append(
                        {
                            "link_name": parts[0],
                            "joint_type": parts[1],
                            "semantic": parts[2],
                        }
                    )
        return out

    def _build_coco_annotation_dict(self):
        img_ids = set()
        for ann in self.annotations:
            img_ids.add(ann["image_id"])
            self.img_link_anno_dict[
                ann["image_id"] * self.num_links + ann["id"]
            ] = ann
        self.num_images = len(img_ids)

    def _parse_joint_info(self):
        self.link_dict = {}
        if len(self.joint_info) != len(self.semantic_data):
            return
        for link_idx, link_data in enumerate(self.joint_info):
            parent = -1
            for i, other in enumerate(self.joint_info):
                if other["id"] == link_data["parent"]:
                    parent = i
                    break
            parsed = {
                "id": link_data["id"],
                "parent": parent,
                "type": link_data["joint"],
                "link_name": self.semantic_data[link_idx]["link_name"],
                "joint_type": self.semantic_data[link_idx]["joint_type"],
                "semantic": self.semantic_data[link_idx]["semantic"],
            }
            self.link_dict[link_idx] = parsed

    def _idx_str(self) -> str:
        names = []
        for link in self.semantic_data:
            s = (
                f"{JOINT_TYPES_MAPPING[link['joint_type']]}_"
                f"{link['semantic']}"
            )
            if s not in names:
                names.append(s)
        return "".join(n + "_" for n in sorted(set(names)))

    def _load_grounding_tasks(self):
        """Pre-generated grounding task banks keyed
        ``{Category}_{joint}_{link}_...json`` (partnet_label.py:346-355)."""
        if not self.grounding_dataset_folder:
            return None
        task_json = os.path.join(
            self.grounding_dataset_folder,
            f"{self.object_cato}_{self._idx_str()}.json",
        )
        if os.path.exists(task_json):
            with open(task_json) as f:
                return json.load(f)[self.object_cato]
        return None

    # -- queries -----------------------------------------------------------------

    def get_annotation(self, img_idx, link_idx, key):
        return self.img_link_anno_dict.get(
            img_idx * self.num_links + link_idx, {}
        ).get(key)

    def is_visible(self, img_idx, link_idx, threshold=1000) -> bool:
        area = self.get_annotation(img_idx, link_idx, "area")
        vis_ratio = self.get_annotation(img_idx, link_idx, "vis_ratio")
        return bool(
            area is not None
            and area > threshold
            and vis_ratio is not None
            and vis_ratio > 0.2
        )

    @staticmethod
    def load_rotated_bbox_from_sem_masks(mask, link_idx):
        """min rotated rect from the semantic mask with the cross-line trick
        (partnet_label.py:537-576)."""
        import cv2

        index = np.where(mask == (link_idx + 1))
        if index[0].size == 0:
            return None, None, None
        m = np.zeros_like(mask)
        m[index] = 255
        ys, xs = np.where(m > 0)
        cv2.line(
            m, (int(xs.min()), int(ys[np.argmin(xs)])),
            (int(xs.max()), int(ys[np.argmax(xs)])), 255, 1,
        )
        cv2.line(
            m, (int(xs[np.argmin(ys)]), int(ys.min())),
            (int(xs[np.argmax(ys)]), int(ys.max())), 255, 1,
        )
        contours, _ = cv2.findContours(
            m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        if not contours:
            return None, None, None
        rect = cv2.minAreaRect(max(contours, key=cv2.contourArea))
        return rect[0], rect[1], rect[2]

    # -- labeling ------------------------------------------------------------------

    def label_instances(
        self, image_folder, vis_thresh=1000, use_eight_points=True,
        normalize_output=True,
    ):
        import cv2

        if len(self.link_dict) == 0:
            return None
        cam = self.cam_info
        intrinsics = np.array(
            [
                [cam["fx"], 0, cam["cx"]],
                [0, cam["fy"], cam["cy"]],
                [0, 0, 1],
            ]
        )
        base = os.path.dirname(image_folder)
        joint_annotations = []
        for image_idx in range(self.num_images):
            image_file = os.path.join(image_folder, f"{image_idx:06d}.png")
            image = cv2.imread(image_file)
            if image is None:
                continue
            mask = cv2.imread(
                os.path.join(base, "mask", f"{image_idx:06d}.png"),
                cv2.IMREAD_GRAYSCALE,
            )
            depth = cv2.imread(
                os.path.join(
                    base, "real_depth_images", f"{image_idx:06d}.png"
                ),
                cv2.IMREAD_UNCHANGED,
            )
            joint_annotations += self.label_one_instance(
                image, depth, mask, image_idx, intrinsics, vis_thresh,
                image_file, use_eight_points=use_eight_points,
                normalize_output=normalize_output,
            )
        return joint_annotations

    def label_one_instance(
        self, image, depth, mask, image_idx, cam_intrinsics, vis_thresh,
        image_full_path, use_eight_points=True, normalize_output=True,
    ):
        """(partnet_label.py:578-821)."""
        joint_annotations = []
        link_info_annos = []
        anno_meta = None
        pcd_full_path = image_full_path  # image path doubles as pcd key

        for link_idx, link_data in self.link_dict.items():
            if not self.is_visible(image_idx, link_idx, vis_thresh):
                continue
            if link_data["type"] not in ("hinge", "slider"):
                continue
            joint_id = str(link_data["id"])
            anno_3d = self.annotations_3d[image_idx]
            if joint_id not in anno_3d:
                continue
            camera_pose = np.array(anno_3d["meta"]["camera_pose"])
            disturbance = np.array(anno_3d["meta"]["disturbance"])
            joint_T_3d = anno_3d[joint_id]["joint_T"]
            disturbance_inv = np.linalg.inv(disturbance)
            camera_pose_inv = np.linalg.inv(camera_pose)

            axis_points_3d = np.array(anno_3d[joint_id]["itp_points"])
            axis_points_3d_cam = (
                axis_points_3d @ disturbance_inv[:3, :3].T
                + disturbance_inv[:3, 3]
            )
            axis_points_3d_cam = (
                axis_points_3d_cam @ camera_pose_inv[:3, :3].T
                + camera_pose_inv[:3, 3]
            )

            bbox_3d = anno_3d[joint_id]["bbox_3d"]
            _bbox_3d = BBox3D(bbox_3d[0:3], bbox_3d[3:6], bbox_3d[6:9])
            _bbox_3d_cam = copy.deepcopy(_bbox_3d)
            _bbox_3d_cam.transform(disturbance_inv)
            _bbox_3d_cam.transform(camera_pose_inv)
            bbox_3d_cam = _bbox_3d_cam.get_array().tolist()

            # axis projected onto the bbox top face (:635-638)
            bbox_pose_inv = np.linalg.inv(_bbox_3d.get_pose())
            axis_points_proj = (
                axis_points_3d @ bbox_pose_inv[:3, :3].T
                + bbox_pose_inv[:3, 3]
            ) / _bbox_3d.extent
            axis_points_proj = np.clip(
                axis_points_proj[0, :2] + 0.5, 0, 1
            )

            # 2D axis endpoints (:639-645)
            axis_points_2d = []
            for point in axis_points_3d_cam:
                p2 = [-point[0] / point[2], point[1] / point[2]]
                axis_points_2d.append(
                    [
                        int(p2[0] * cam_intrinsics[0, 0] + cam_intrinsics[0, 2]),
                        int(p2[1] * cam_intrinsics[1, 1] + cam_intrinsics[1, 2]),
                    ]
                )
            axis_points_2d = np.array(axis_points_2d, np.int32)

            # axis rotated-bbox (:651-666)
            bbox_center = (axis_points_2d[0] + axis_points_2d[1]) / 2
            bbox_w = float(
                np.linalg.norm(axis_points_2d[0] - axis_points_2d[1])
            )
            bbox_h = min(bbox_w, 10)
            joint_pos_angle = np.arctan2(
                axis_points_2d[1, 1] - axis_points_2d[0, 1],
                axis_points_2d[1, 0] - axis_points_2d[0, 0],
            )
            angle = joint_pos_angle * 180 / np.pi
            angle_flip = False
            if angle < 0:
                angle = 180 + angle
                angle_flip = True
            joint_angle = normalize_and_round_angle(angle, range_end=180)
            axis_rot_bbox = [
                bbox_center[0], bbox_center[1], bbox_w, bbox_h, joint_angle,
            ]

            # 2D link boxes (:668-689)
            child_bbox = self.get_annotation(image_idx, link_idx, "bbox")
            child_rot_bbox = self.get_annotation(
                image_idx, link_idx, "rot_bbox"
            )
            c_sem, _, _ = self.load_rotated_bbox_from_sem_masks(
                mask, link_idx
            )
            if child_bbox is None or child_rot_bbox is None or c_sem is None:
                continue
            child_rot_bbox = list(child_rot_bbox)
            child_rot_bbox[-1] = normalize_and_round_angle(
                child_rot_bbox[-1], range_end=180
            )
            parent_bbox = self.get_annotation(
                image_idx, link_data["parent"], "bbox"
            )
            parent_rot_bbox = self.get_annotation(
                image_idx, link_data["parent"], "rot_bbox"
            )
            p_sem, _, _ = self.load_rotated_bbox_from_sem_masks(
                mask, link_data["parent"]
            )
            if parent_bbox is None or parent_rot_bbox is None or p_sem is None:
                continue
            parent_rot_bbox = list(parent_rot_bbox)
            parent_rot_bbox[-1] = normalize_and_round_angle(
                parent_rot_bbox[-1], range_end=180
            )

            # 2.5D depth extension (:691-702)
            zero_mask = depth == 0
            depth_m = depth / 1000.0
            depth_min = float(depth_m[~zero_mask].min())
            depth_max = float(depth_m[~zero_mask].max())
            d0 = abs(axis_points_3d_cam[0, 2])
            d1 = abs(axis_points_3d_cam[1, 2])
            d0 = (d0 - depth_min) / (depth_max - depth_min)
            d1 = (d1 - depth_min) / (depth_max - depth_min)
            if angle_flip:
                d0, d1 = d1, d0
            axis_rot_bbox_ext = axis_rot_bbox[:5] + [d0, d1]

            # open/closed (:704-716)
            joint_value = 0.0
            for link_name in self.info:
                if link_name.startswith(link_data["link_name"]):
                    joint_value = self.info[link_name][image_idx]
            closed = joint_value < 0.2

            joint_annotations.append(
                {
                    "image_idx": image_idx,
                    "semantic": link_data["semantic"],
                    "camera_pose": camera_pose.tolist(),
                    "camera_intrinsics": cam_intrinsics.tolist(),
                    "depth_min": depth_min,
                    "depth_max": depth_max,
                    "axis_rot_bbox": [float(x) for x in axis_rot_bbox],
                    "axis_rot_bbox_ext": [
                        float(x) for x in axis_rot_bbox_ext
                    ],
                    "child_rot_bbox": _flatten_rect(child_rot_bbox),
                    "parent_rot_bbox": _flatten_rect(parent_rot_bbox),
                    "joint_type": link_data["joint_type"],
                    "joint_value": float(joint_value),
                    "joint_T_3d": joint_T_3d,
                    "bbox_3d": list(bbox_3d),
                    "bbox_3d_cam": bbox_3d_cam,
                    "axis_3d": axis_points_3d.tolist(),
                    "axis_3d_cam": axis_points_3d_cam.tolist(),
                    "axis_3d_proj": axis_points_proj.tolist(),
                    "closed": bool(closed),
                }
            )

            anno_meta = {
                "intrinsics": cam_intrinsics,
                "camera_pose": np.eye(4),
                "depth_min": depth_min,
                "depth_max": depth_max,
                "img_width": image.shape[1],
                "img_height": image.shape[0],
            }

            child_rb = _flatten_rect(child_rot_bbox)
            joint_type_urdf = JOINT_TYPES_MAPPING[link_data["joint_type"]]
            link_info = random.choice([child_rb, link_data["semantic"]])

            self.vqa_tasks["single_link_rec_tasks"].append(
                T.create_single_link_rec_rotated_task(
                    link_data["semantic"], child_rb, image_full_path
                )
            )
            self.vqa_tasks["joint_rec_tasks"].append(
                T.create_rec_joint_rotated_task(
                    link_info, axis_rot_bbox, joint_type_urdf, image_full_path
                )
            )
            self.vqa_tasks["joint_rec_ext_tasks"].append(
                T.create_rec_joint_rotated_ext_task(
                    link_info, axis_rot_bbox_ext, joint_type_urdf,
                    image_full_path,
                )
            )
            self.vqa_tasks["joint_rec_sep_depth_tasks"].append(
                T.create_rec_joint_rotated_ext_task_with_sep_depth(
                    link_info, axis_rot_bbox_ext, joint_type_urdf,
                    image_full_path,
                )
            )
            self.vqa_tasks["single_link_3d_rec_tasks"].append(
                T.create_single_link_3d_rec_task(
                    link_data["semantic"], bbox_3d_cam, pcd_full_path,
                    anno_meta=anno_meta, normalize=normalize_output,
                    use_eight_points=use_eight_points,
                )
            )
            self.vqa_tasks["joint_3d_rec_tasks"].append(
                T.create_3d_rec_joint_task(
                    bbox_3d_cam, axis_points_3d_cam, joint_type_urdf,
                    pcd_full_path, anno_meta=anno_meta,
                    normalize=normalize_output,
                    use_eight_points=use_eight_points,
                )
            )

            link_name_with_status = link_data["semantic"]
            if self.opened_closed_status_parts and (
                link_data["semantic"] in self.opened_closed_status_parts
            ):
                self.vqa_tasks["status_joint_reg_tasks"].append(
                    T.create_reg_status_qa_task(
                        link_info, closed, image_full_path
                    )
                )
                self.vqa_tasks["status_joint_3d_reg_tasks"].append(
                    T.create_3d_reg_status_qa_task(
                        bbox_3d_cam, closed, pcd_full_path,
                        anno_meta=anno_meta, normalize=normalize_output,
                        use_eight_points=use_eight_points,
                    )
                )
                link_name_with_status = (
                    ("closed_" if closed else "opened_")
                    + link_data["semantic"]
                )

            link_info_annos.append(
                {
                    "link_name": link_data["semantic"],
                    "bbox": child_rb,
                    "joint_type": joint_type_urdf,
                    "link_name_status": link_name_with_status,
                    "bbox_3d": bbox_3d_cam,
                    "axis_3d": axis_points_3d_cam,
                }
            )

        if link_info_annos:
            self.vqa_tasks["all_parts_det_tasks"].append(
                T.create_det_all_rotated_task(
                    link_info_annos, image_full_path
                )
            )
            self.vqa_tasks["all_parts_3d_det_tasks"].append(
                T.create_det_all_bbox_3d_task(
                    link_info_annos, pcd_full_path, anno_meta=anno_meta,
                    normalize=normalize_output,
                    use_eight_points=use_eight_points,
                )
            )
            if self.grounding_tasks:
                possible = {}
                for li in link_info_annos:
                    key = li["link_name_status"]
                    if key in self.grounding_tasks:
                        possible[key] = self.grounding_tasks[key]
                g = T.create_grounding_task(
                    possible, link_info_annos, image_full_path,
                    indexing="bbox",
                )
                if g:
                    self.vqa_tasks["grounding_tasks"].append(g)
                g3 = T.create_3d_grounding_task(
                    possible, link_info_annos, pcd_full_path,
                    indexing="bbox_3d", anno_meta=anno_meta,
                    normalize=normalize_output,
                    use_eight_points=use_eight_points,
                )
                if g3:
                    self.vqa_tasks["grounding_3d_tasks"].append(g3)
        return joint_annotations


def _flatten_rect(rect):
    """cv2 minAreaRect tuples ((cx,cy),(w,h),angle) -> [cx,cy,w,h,angle]."""
    if len(rect) == 5:
        return [float(x) for x in rect]
    (cx, cy), (w, h), angle = rect
    return [float(cx), float(cy), float(w), float(h), float(angle)]


def label_one_data(
    data_name, grounding_dataset_folder, data_dir, output_dir,
    vis_thresh=1000, use_eight_points=True, normalize_output=True,
):
    """(partnet_label.py:824-902)"""
    data_name = str(data_name)
    export = os.path.join(output_dir, data_name)
    image_folder = os.path.join(export, "raw_images")
    if not os.path.exists(image_folder) or not os.listdir(image_folder):
        print(f"Skip {data_name}: no images")
        return {}
    required = [
        os.path.join(data_dir, data_name, "mobility.urdf"),
        os.path.join(export, "annotations.json"),
        os.path.join(export, "mobility_v2.json"),
        os.path.join(export, "info.json"),
        os.path.join(export, "semantics.txt"),
    ]
    if not all(os.path.exists(p) for p in required):
        return "FileNotComplete"
    try:
        labeler = PartNetLabeler(grounding_dataset_folder)
        labeler.read_info(
            os.path.join(export, "mobility_v2.json"),
            os.path.join(export, "info.json"),
            os.path.join(export, "annotations.json"),
            os.path.join(export, "annotations_3d.json"),
            os.path.join(export, "semantics.txt"),
        )
        annos = labeler.label_instances(
            image_folder, vis_thresh=vis_thresh,
            use_eight_points=use_eight_points,
            normalize_output=normalize_output,
        )
        if annos is not None:
            with open(
                os.path.join(export, "joint_annotations.json"), "w"
            ) as f:
                json.dump(annos, f)
            return labeler.vqa_tasks
        return {}
    except Exception as e:
        print(f"Error: {data_name} failed to label with error {e}")
        return str(e)


def save_annotations(task_annotations, task_folder, cato):
    """Per-split per-task-stream JSON dumps named
    ``{task}_{cato}_{count}.json`` (partnet_label.py:46-136)."""
    os.makedirs(task_folder, exist_ok=True)
    written = []
    for task, tasks in task_annotations.items():
        if not tasks:
            continue
        path = os.path.join(task_folder, f"{task}_{cato}_{len(tasks)}.json")
        with open(path, "w") as f:
            json.dump(tasks, f)
        written.append(path)
    return written


def split_train_val(classname_json: str):
    """Train/val split by HOLDOUT_CLASSES over the classname map
    (partnet_label.py:982-995)."""
    with open(classname_json) as f:
        data = json.load(f)
    val_ids, train_ids = [], []
    for class_name, ids in data.items():
        (val_ids if class_name in HOLDOUT_CLASSES else train_ids).extend(ids)
    return {"train": train_ids, "val": val_ids}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("label rendered objects -> VQA tasks")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_name", default="all")
    p.add_argument("--vqa_tasks_folder", default="./vqa_tasks")
    p.add_argument("--grounding_dataset_folder", default=None)
    p.add_argument("--classname_file", default=None)
    p.add_argument("--vis_thresh", type=int, default=196)
    args = p.parse_args(argv)

    if args.data_name != "all":
        result = label_one_data(
            args.data_name, args.grounding_dataset_folder, args.data_dir,
            args.output_dir, vis_thresh=args.vis_thresh,
        )
        if not isinstance(result, dict):
            print(f"Error: {args.data_name} failed to label: {result}")
            return
        save_annotations(result, args.vqa_tasks_folder, args.data_name)
        return

    assert args.classname_file, "--classname_file required for --data_name all"
    splits = split_train_val(args.classname_file)
    for split, ids in splits.items():
        merged = {k: [] for k in TASK_STREAMS}
        for data_name in ids:
            result = label_one_data(
                str(data_name), args.grounding_dataset_folder,
                args.data_dir, args.output_dir, vis_thresh=args.vis_thresh,
            )
            if isinstance(result, dict):
                for k in TASK_STREAMS:
                    merged[k].extend(result.get(k, []))
        save_annotations(
            merged, os.path.join(args.vqa_tasks_folder, split), split
        )


if __name__ == "__main__":
    main()
