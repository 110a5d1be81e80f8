"""The port's datagen copies against the JAX package's: the same seeded
object and inputs through both, with equal outputs.

The pipeline (tests/test_datagen_pipeline.py's synthetic box with a hinged
lid, 192 px, 2 camera poses x 2 joint values) is rendered once per package
(``render_data_item``, ``process_one_data``, ``label_one_data``,
``save_annotations``); every file each writes is compared: images and depth
maps decoded, point clouds and ``.npy`` files as arrays, JSON with the
output roots taken out, exactly. Then tests/test_datagen_core.py's cases
(URDF parsing, forward kinematics and the fixer, OBJ/MTL meshes with
textures, the rasterizer's native and numpy routes) and
tests/test_tools_extras.py's datagen cases (the two-stage demo builder,
grounding banks with a stub chat client, the annotation visualizer, the
texture-augmentation index and the ControlNet loop with a stub pipeline)
run in both packages on the same inputs."""

import importlib
import json
import os
import random
from pathlib import Path

import numpy as np
import pytest

from tests.test_datagen_core import URDF_XML as CORE_URDF
from tests.test_datagen_core import _quad_scene, _textured_quad_obj
from tests.test_datagen_pipeline import (
    CAMERA_INFO,
    MOBILITY_V2,
    SEMANTICS,
    URDF_XML,
)

PACKAGES = ("a3vlm_tpu", "a3vlm_tpu_torch")


def _mods(name: str):
    """The module ``datagen.<name>`` of each package: (JAX's, the port's)."""
    return tuple(importlib.import_module(f"{pkg}.datagen.{name}")
                 for pkg in PACKAGES)


def _read(path: Path, root: Path):
    """A written file in a form to compare: images decoded (cv2, as the
    pipeline writes them), ``.npy`` arrays, JSON with ``root`` taken out,
    anything else as bytes."""
    import cv2

    if path.suffix == ".png":
        return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".json":
        return json.loads(path.read_text().replace(str(root), "<root>"))
    return path.read_bytes().replace(str(root).encode(), b"<root>")


def _same_tree(a: Path, b: Path, root_a: Path, root_b: Path) -> int:
    """Every file under ``a`` and ``b`` is there in both and equal; returns
    the count."""
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b
    for rel in files_a:
        x, y = _read(a / rel, root_a), _read(b / rel, root_b)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, rel
            np.testing.assert_array_equal(x, y, err_msg=str(rel))
        else:
            assert x == y, rel
    return len(files_a)


def _write_object(obj: Path) -> None:
    obj.mkdir(parents=True)
    (obj / "mobility.urdf").write_text(URDF_XML)
    (obj / "meta.json").write_text(json.dumps({"model_cat": "Box"}))
    (obj / "semantics.txt").write_text(SEMANTICS)
    (obj / "mobility_v2.json").write_text(json.dumps(MOBILITY_V2))


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Both packages' datagen over the same object, each under a root of
    its own; the trees are snapshot after each stage (renders, point
    clouds and 3D labels, labels and task files)."""
    import shutil

    out = {}
    for pkg in PACKAGES:
        root = tmp_path_factory.mktemp(pkg)
        render_robot = importlib.import_module(
            f"{pkg}.datagen.render_robot")
        point_render = importlib.import_module(
            f"{pkg}.datagen.point_render")
        labeler = importlib.import_module(f"{pkg}.datagen.labeler")
        data_dir, render_dir = root / "dataset", root / "render"
        _write_object(data_dir / "101")
        assert render_robot.render_data_item(
            "101", str(data_dir), str(render_dir), num_poses=2,
            camera_info=CAMERA_INFO, num_joint_value=2, cam_radius_min=3.0,
            cam_radius_max=4.0, seed=0)
        shutil.copytree(render_dir, root / "after_render")
        assert point_render.process_one_data(
            "101", str(render_dir), sample_size=4096, gaussian_noise=0.002,
            export_npy=True, npy_points=512, export_ply=True, seed=0)
        shutil.copytree(render_dir, root / "after_points")
        random.seed(0)  # the labeler draws from the global RNG
        tasks = labeler.label_one_data(
            "101", None, str(data_dir), str(render_dir), vis_thresh=100,
            use_eight_points=True, normalize_output=True)
        files = labeler.save_annotations(tasks, str(root / "vqa"), "Box")
        out[pkg] = (root, tasks, files)
    return out


@pytest.mark.parametrize("stage,sub", [
    ("render", "after_render"),       # raw, depth and mask images, info
    ("points", "after_points"),       # annotations_3d.json, .npy, .ply
    ("labels", "render"),             # joint_annotations.json
    ("tasks", "vqa"),                 # the VQA task files
])
def test_pipeline_outputs_equal_jax(pipeline, stage, sub):
    (ra, _, _), (rb, _, _) = (pipeline[p] for p in PACKAGES)
    n = _same_tree(ra / sub, rb / sub, ra, rb)
    assert n >= {"render": 18, "points": 24, "labels": 25, "tasks": 10}[stage]


def test_label_streams_equal_jax(pipeline):
    (ra, ta, fa), (rb, tb, fb) = (pipeline[p] for p in PACKAGES)
    assert [Path(f).name for f in fa] == [Path(f).name for f in fb]
    assert json.loads(json.dumps(ta).replace(str(ra), "<root>")) == \
        json.loads(json.dumps(tb).replace(str(rb), "<root>"))
    assert len(ta["single_link_3d_rec_tasks"]) > 0
    assert len(ta["joint_3d_rec_tasks"]) > 0


# -- tests/test_datagen_core.py's cases in both packages ---------------------


def test_urdf_parse_fk_and_fixer(tmp_path):
    results = []
    for urdf in _mods("urdf"):
        p = tmp_path / "mobility.urdf"
        p.write_text(CORE_URDF)
        robot = urdf.URDF.load(str(p))
        prismatic = tmp_path / "m.urdf"
        prismatic.write_text(CORE_URDF.replace('type="revolute"',
                                               'type="prismatic"'))
        broken = tmp_path / "broken.urdf"
        broken.write_text(
            '<robot name="x">\n<joint name="j" type="revolute">\n'
            '<limit lower="None" upper="1"/>\n'
            '<parent link="a"/><child link="b"/>\n</joint>\n'
            '<link name="a"/><link name="b"/>\n</robot>\n')
        fixed = urdf.modify_urdf(str(broken))
        results.append((
            robot.base_link, [j.joint_type for j in robot.joints],
            robot.joints[0].limit.upper, len(robot.actuated_joints),
            robot.link_fk({"joint_0": np.pi / 2}),
            urdf.URDF.load(str(prismatic)).link_fk({"joint_0": 0.3}),
            urdf.compute_kinematic_level(robot), fixed, broken.read_text(),
            sorted(urdf.URDF.load(str(broken)).link_fk({"j": 0.5}))))
    a, b = results
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        else:
            assert x == y


def test_obj_meshes_and_textures(tmp_path):
    got = []
    for mesh in _mods("mesh"):
        d = tmp_path / mesh.__name__.split(".")[0]
        d.mkdir()
        box = mesh.box_mesh([1, 2, 3])
        box.export_obj(str(d / "box.obj"))
        (d / "mat.mtl").write_text("newmtl red\nKd 1.0 0.0 0.0\n")
        (d / "tri.obj").write_text(
            "mtllib mat.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
            "usemtl red\nf 1 2 3 4\n")
        tex = mesh.load_obj(_textured_quad_obj(d))
        both = mesh.concatenate([mesh.load_obj(str(d / "box.obj")),
                                 mesh.load_obj(str(d / "tri.obj"))])
        got.append([(d / "box.obj").read_text()] + [
            np.asarray(x) for m in (mesh.load_obj(str(d / "tri.obj")), both)
            for x in (m.vertices, m.faces, m.face_colors)] + [
            tex.face_uvs, tex.face_texture, tex.textures[0]])
    a, b = got
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("force_numpy", [True, False],
                         ids=["numpy", "native"])
def test_rasterizer_routes_equal_jax(tmp_path, force_numpy):
    """Both routes of ``rasterize`` and ``rasterize_uv`` give the JAX
    package's outputs on the quad scene, an occluding pair and random
    triangles; the textured quad shades alike."""
    pairs = _mods("rasterizer")
    if not force_numpy:
        assert all(m._load_native() is not None for m in pairs)
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    v[:, 2] = -rng.uniform(1.5, 3.0, 30)
    f = rng.integers(0, 30, (40, 3)).astype(np.int32)
    ids = rng.integers(0, 5, 40).astype(np.int32)
    uvs = rng.uniform(0, 1, (40, 3, 2)).astype(np.float32)
    (v1, f1), (v2, f2) = _quad_scene(2.0), _quad_scene(1.0)
    scenes = [(v1, f1, np.array([7, 7], np.int32)), (v, f, ids),
              (np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4]),
               np.array([0, 0, 1, 1], np.int32))]
    kw = dict(fx=80, fy=80, cx=32, cy=32, width=64, height=64,
              force_numpy=force_numpy)
    for verts, faces, face_ids in scenes:
        a, b = (m.rasterize(verts, faces, face_ids, **kw) for m in pairs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    a, b = (m.rasterize_uv(v, f, None, uvs, **kw) for m in pairs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    shaded = []
    for mesh, ras in zip(_mods("mesh"), pairs):
        d = tmp_path / ras.__name__.split(".")[0]
        d.mkdir()
        m = mesh.load_obj(_textured_quad_obj(d))
        verts = m.vertices.copy().astype(np.float32)
        verts[:, 2] = -2.0
        depth, face_idx, _, uv = ras.rasterize_uv(
            verts, m.faces, None, m.face_uvs, **kw)
        albedo = ras.sample_textures(face_idx, uv, m.face_texture,
                                     m.textures, m.face_colors)
        normals = np.tile([0.0, 0.0, 1.0], (len(m.faces), 1))
        lights = np.array([[0.0, 0.0, 1.0], [0.6, 0.8, 0.0]])
        shaded.append((depth, albedo,
                       ras.shade_albedo(normals, albedo, face_idx, lights),
                       ras.shade_lambert(normals, m.face_colors, face_idx,
                                         lights)))
    for x, y in zip(*shaded):
        np.testing.assert_array_equal(x, y)


def test_native_library_is_the_ports_own():
    """The port builds its rasterizer into its own git-ignored build
    directory under a name of its own, not the JAX package's shared
    temporary-directory library."""
    from a3vlm_tpu_torch.datagen import rasterizer

    lib = rasterizer._load_native()
    assert lib is not None
    path = Path(lib._name)
    assert path.parent == Path(rasterizer.__file__).parent.parent / "_build"
    assert path.name == "liba3vlm_torch_rasterizer.so"


def test_render_parts_textured_visual_pass(tmp_path):
    got = []
    for mesh, render in zip(_mods("mesh"), _mods("render")):
        d = tmp_path / render.__name__.split(".")[0]
        d.mkdir()
        m = mesh.load_obj(_textured_quad_obj(d))
        cam_pose = np.eye(4)
        cam_pose[2, 3] = 2.0
        got.append(render.render_parts(
            {"quad_0": (m, np.eye(4))}, 1,
            dict(fx=100.0, fy=100.0, cx=32.0, cy=32.0, width=64, height=64),
            2.0, 1.0, predefine_camera_poses=[cam_pose], is_link_map=False,
            rng=np.random.default_rng(0)))
    for x, y in zip(*got):
        for p, q in zip(x, y):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


# -- tests/test_tools_extras.py's datagen cases in both packages -------------


def test_two_stage_demo_builder(tmp_path):
    from PIL import Image

    got = []
    for mod in _mods("create_demo_json"):
        root = tmp_path / mod.__name__.split(".")[0]
        img_dir = root / "eval_prepare" / "obj1"
        img_dir.mkdir(parents=True)
        Image.new("RGB", (32, 32)).save(img_dir / "color.png")
        step1 = json.loads(Path(mod.create_json_step1(str(root))).read_text())
        one_box = "[" + ",".join(["[10.00,20.00,30.00]"] * 8) + "]"
        results = [{"image": step1[0]["image"],
                    "answer": f"<box>door</box>{one_box},"
                              f"<box>lid</box>{one_box}"}]
        (root / "step1.json").write_text(json.dumps(results))
        step2 = mod.create_json_step2(str(root / "step1.json"),
                                      str(root / "step2.json"))
        got.append(json.loads(json.dumps(
            [step1, json.loads(Path(step2).read_text()),
             [b.tolist() for b in mod.parse_boxes_from_answer(
                 results[0]["answer"])]]).replace(str(root), "<root>")))
    assert got[0] == got[1]
    assert len(got[0][1]) == 2


def _grounding_object(root: Path, obj_id: str) -> None:
    obj = root / "obj" / obj_id
    obj.mkdir(parents=True)
    (obj / "mobility.urdf").write_text(
        '<robot name="b"><link name="link_0"/><link name="link_1"/>'
        '<joint name="j" type="revolute"><parent link="link_0"/>'
        '<child link="link_1"/><axis xyz="1 0 0"/>'
        '<limit lower="0" upper="1"/></joint></robot>')
    (obj / "semantics.txt").write_text(
        "link_0 heavy box_body\nlink_1 hinge rotation_lid\n")
    (obj / "meta.json").write_text(json.dumps({"model_cat": "Box"}))


def test_grounding_banks_and_labeler_key(tmp_path):
    """The template bank, then the chat-client route with a stub client
    (fenced JSON, a history merge, the task cap and an unparseable reply),
    and the labeler finding the bank by its key."""
    got = []
    for grounding, labeler in zip(_mods("grounding_tasks"),
                                  _mods("labeler")):
        root = tmp_path / grounding.__name__.split(".")[0]
        _grounding_object(root, "101")
        _grounding_object(root, "102")
        random.seed(0)
        path = grounding.generate_bank_for_object(
            str(root / "obj"), "101", str(root / "banks"))
        prompts = []

        def stub(system_msg, user_msg, _prompts=prompts):
            _prompts.append((system_msg, user_msg))
            return "```json\n" + json.dumps({"Box": {"open_lid": {
                "description": "Open the lid.",
                "actions": ["flap_open[rotation_lid]",
                            "StatusComplete"]}}}) + "\n```"

        def stub2(system_msg, user_msg, _prompts=prompts):
            _prompts.append((system_msg, user_msg))
            return json.dumps({"Box": {"close_lid": {
                "description": "Close the lid.",
                "actions": ["flap_close[rotation_lid]",
                            "StatusComplete"]}}})

        states = [grounding.generate_openai_tasks(
            str(root / "obj"), "102", str(root / "banks2"), client=c,
            **kw) for c, kw in ((stub, {}), (stub2, {}),
                                (stub, {"max_tasks": 2}))]
        states.append(grounding.generate_openai_tasks(
            str(root / "obj"), "102", str(root / "banks3"),
            client=lambda *a: "not json at all"))
        lab = labeler.PartNetLabeler(str(root / "banks"))
        lab.semantic_data = [
            {"link_name": "link_0", "joint_type": "heavy",
             "semantic": "box_body"},
            {"link_name": "link_1", "joint_type": "hinge",
             "semantic": "rotation_lid"}]
        lab.object_cato = "Box"
        banks = {p.relative_to(root).as_posix(): p.read_text()
                 for p in sorted(root.rglob("banks*/**/*")) if p.is_file()}
        got.append(json.loads(json.dumps(
            [Path(path).name, states, prompts, banks,
             lab._load_grounding_tasks()]).replace(str(root), "<root>")))
    assert got[0] == got[1]
    assert got[0][1] == ["Success", "Success", "SKIP", "Fail"]


def test_annotation_visualizer(tmp_path):
    from PIL import Image

    import cv2

    img = tmp_path / "img.png"
    Image.new("RGB", (64, 64), (10, 10, 10)).save(img)
    one_box = "[" + ",".join(["[50.00,50.00,40.00]"] * 8) + "]"
    tasks = [{"image": str(img), "conversations": [
        {"from": "human", "value": "q"}, {"from": "gpt", "value": a}]}
        for a in ("<axis>revolute</axis>[10.00,10.00,50.00,90.00,90.00,"
                  "50.00]", one_box, "[0.50,0.50,0.30,0.20,0.00]")]
    tf = tmp_path / "tasks.json"
    tf.write_text(json.dumps(tasks))
    got = []
    for mod in _mods("annotation_visualizer"):
        random.seed(0)
        out = tmp_path / mod.__name__.split(".")[0]
        written = mod.visualize_task_file(str(tf), str(out), sample_num=3)
        got.append([(Path(w).name, cv2.imread(w)) for w in written])
    assert len(got[0]) == 3
    for (na, a), (nb, b) in zip(*got):
        assert na == nb
        np.testing.assert_array_equal(a, b)


def test_texture_aug_index_and_controlnet_loop(tmp_path):
    """``colorize_seg_ade``, the prompt bank, the CSV index and the
    ControlNet loop with a stub pipeline (depth and seg control)."""
    import cv2
    from PIL import Image

    class StubResult:
        def __init__(self, images):
            self.images = images

    got = []
    for mod in _mods("texture_aug"):
        root = tmp_path / mod.__name__.split(".")[0]
        mask = np.zeros((16, 16), np.uint8)
        mask[4:8] = 1
        mask[8:12] = 3
        obj = root / "render" / "202"
        (obj / "depth_images").mkdir(parents=True)
        (obj / "mask").mkdir()
        (obj / "meta.json").write_text(json.dumps({"model_cat": "Door"}))
        cv2.imwrite(str(obj / "depth_images" / "000001.png"), mask)
        cv2.imwrite(str(obj / "mask" / "000001.png"), mask)
        bank = mod.generate_prompt_bank(["Door", "Box"],
                                        str(root / "bank.json"), n=3)
        prompts = root / "prompts.json"
        prompts.write_text(json.dumps({"Door": ["a red door"]}))
        csv_path = root / "index.csv"
        n = mod.construct_dataset_index(str(root / "render"), str(prompts),
                                        str(csv_path))
        calls = []

        def stub_pipe(prompt, image=None, num_images_per_prompt=1,
                      _calls=calls):
            _calls.append((prompt, image.size, np.asarray(image).tolist()))
            return StubResult([Image.new("RGB", (16, 16), (i * 40, 0, 0))
                               for i in range(num_images_per_prompt)])

        for control, k in (("depth", 2), ("seg", 1)):
            mod.run_controlnet(str(csv_path), str(root / "out"),
                               control=control, images_per_prompt=k,
                               pipe=stub_pipe)
        outs = {p.relative_to(root).as_posix(): cv2.imread(str(p))
                for p in sorted((root / "out").rglob("*.png"))}
        got.append((mod.colorize_seg_ade(mask), Path(bank).read_text(), n,
                    csv_path.read_text().replace(str(root), "<root>"),
                    calls, outs))
    (seg_a, *rest_a, outs_a), (seg_b, *rest_b, outs_b) = got
    np.testing.assert_array_equal(seg_a, seg_b)
    assert rest_a == rest_b
    assert outs_a.keys() == outs_b.keys() and len(outs_a) == 3
    for k in outs_a:
        np.testing.assert_array_equal(outs_a[k], outs_b[k])


def test_point_render_helpers(tmp_path):
    """``_save_ply``, the normal estimate and the 3D label of one frame."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(200, 3))
    cols = rng.uniform(size=(200, 3))
    got = []
    for mod in _mods("point_render"):
        out = tmp_path / (mod.__name__.split(".")[0] + ".ply")
        normals = mod.estimate_normals_for_cloud(pts, k=8)
        mod._save_ply(str(out), pts, normals, cols)
        got.append((normals, out.read_text(),
                    mod.jitter_brightness(cols, rng=np.random.default_rng(1)),
                    mod.vector_fix(np.array([0.0, -1.0, 0.5]))))
    for x, y in zip(*got):
        if isinstance(x, str):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)
    assert os.path.getsize(tmp_path / "a3vlm_tpu.ply") > 0
