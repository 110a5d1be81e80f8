"""Domain vocabulary: categories, action primitives, instruction strings,
delimiters, joint-type mapping, holdout split (reference
data_gen/vqa_config.py — these strings ARE the model's I/O contract and must
match byte-for-byte)."""

OPEN_CLOSE_STATUS = {
    "Toilet": ["lid", "seat"],
    "Door": ["surface_board", "rotation_door"],
    "Laptop": ["shaft"],
    "StorageFurniture": ["cabinet_door", "door", "drawer"],
    "Table": ["drawer"],
    "Window": ["rotation", "translation"],
    "TrashCan": ["lid"],
    "USB": ["cap"],
    "Refrigerator": ["door", "other_leaf"],
    "Microwave": ["door"],
    "Oven": ["door"],
    "Dishwasher": ["door"],
    "Pen": ["cap"],
    "Safe": ["door"],
    "WashingMachine": ["door"],
    "Box": ["rotation_lid"],
    "Stapler": ["lid"],
    "Suitcase": ["lid"],
    "Phone": ["flipping_lid", "rotation_lid", "slider"],
}

ACTION_PRIMITIVES = [
    "slide_open", "slide_close", "flap_open", "flap_close", "cap", "uncap",
    "pick", "place", "slide_in", "slide_out", "wipe", "press", "rotate",
    "StatusComplete",
]

# 2D task instructions (vqa_config.py:33-41)
DET_ALL_ROT_INSTRUCT = (
    "Detect all manipulable object parts and provide their 2D rotated "
    "bounding boxes."
)
DET_ALL_INSTRUCT = (
    "Detect all manipulable object parts and provide their 2D bounding boxes."
)
REC_JOINT_ROT_INSTRUCT = (
    "Please provide the joint's type and its 2D rotated bounding box linked "
    "to the object part {REF}."
)
REC_JOINT_ROT_EXT_INSTRUCT = (
    "Please provide the joint's type and its 2D rotated bounding box with "
    "depth linked to the object part {REF}."
)
REG_STATUS_INSTRUCT = "What is the status of the object part {REF}?"
REC_SINGLE_LINK_INSTRUCT = (
    "Please provide the 2D rotated bounding box of the region this sentence "
    "describes: "
)
GROUNDING_ACTIONS_INSTRUCT = (
    "Please execute the task described wih 2D rotated bounding box "
    "representations by the following instruction: "
)  # (sic "wih" — kept byte-identical to the reference)

# 3D task instructions (vqa_config.py:43-50)
DET_ALL_BBOX_3D_INSTRUCT = (
    "Detect all manipulable object parts and provide their 3D bounding boxes."
)
DET_ALL_3D_INSTRUCT = (
    "Detect all manipulable object parts and provide their 3D bounding boxes."
)
REC_JOINT_3D_INSTRUCT = (
    "Please provide the joint's type and its 3D axis linked to the object "
    "part {REF}."
)
REG_STATUS_3D_INSTRUCT = "What is the status of the object part {REF}?"
REC_SINGLE_LINK_3D_INSTRUCT = (
    "Please provide the 3D bounding box of the region this sentence "
    "describes: "
)
GROUNDING_ACTIONS_3D_INSTRUCT = (
    "Please execute the task described wih 3D rotated bounding box "
    "representations by the following instruction: "
)
DET_AFFORDANCE_3D_INSTRUCT = (
    "Please provide the 3D bounding box of the region where the action could "
    "be applied: "
)

# delimiters (vqa_config.py:53-67)
DELIM_RB_START, DELIM_RB_END = "<rb>", "</rb>"
DELIM_RBD_START, DELIM_RBD_END = "<rbd>", "</rbd>"
DELIM_DEP_START, DELIM_DEP_END = "<dep>", "</dep>"
DELIM_P_START, DELIM_P_END = "<p>", "</p>"
DELIM_BOX_START, DELIM_BOX_END = "<box>", "</box>"
DELIM_AXIS_START, DELIM_AXIS_END = "<axis>", "</axis>"

JOINT_TYPES_MAPPING = {
    "free": "continuous",
    "heavy": "fixed",
    "hinge": "revolute",
    "slider": "prismatic",
    "slider+": "prismatic",
    "static": "fixed",
}

NONE_PLACEHOLDER = -10000
DET_ALL_SKIPPED_CLASS = ["Keyboard", "Phone", "Remote"]
HOLDOUT_CLASSES = [
    "Toilet", "USB", "Scissors", "Stapler", "Kettle", "Oven", "Phone",
    "WashingMachine",
]

NUMBER_WORDS = {
    1: "one", 2: "two", 3: "three", 4: "four", 5: "five", 6: "six",
    7: "seven", 8: "eight", 9: "nine", 10: "ten", 11: "eleven",
}
