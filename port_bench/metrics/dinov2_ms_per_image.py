"""The DINOv2 tower's device ms an image sent (a render counts once a
question), its input's renormalisation included: the program's
``dinov2_ms`` (the ``towers.dinov2`` span's CUDA-event pair) summed over
the window's batches, over the images those batches sent."""


def read(run):
    b = run["batches"]
    sent = sum(x["images_sent"] for x in b)
    if not sent or any("dinov2_ms" not in x for x in b):
        return None
    return sum(x["dinov2_ms"] for x in b) / sent
