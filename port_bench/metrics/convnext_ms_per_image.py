"""The ConvNeXt tower's device ms an image sent (a render counts once a
question): the program's ``convnext_ms`` (the ``towers.convnext`` span's
CUDA-event pair) summed over the window's batches, over the images those
batches sent."""


def read(run):
    b = run["batches"]
    sent = sum(x["images_sent"] for x in b)
    if not sent or any("convnext_ms" not in x for x in b):
        return None
    return sum(x["convnext_ms"] for x in b) / sent
