"""Metric logging for training (counterpart of the part of
a3vlm_tpu/utils/logging.py that the epoch loop and the CLI use):
windowed meters, a printing iterator with iteration/data times and the
device's peak memory, and per-epoch JSON lines."""

from __future__ import annotations

import datetime
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Iterable, Optional

import torch


class SmoothedValue:
    """Windowed median / average tracker (logging.py:35)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def _device_mem_gib() -> Optional[float]:
    """Peak device memory allocated by PyTorch on the current GPU, in GiB;
    None without a GPU."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated() / 2**30


class MetricLogger:
    """Named meters and a printing iterator (logging.py:92)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is not None:
                self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        if total is None and hasattr(iterable, "__len__"):
            total = len(iterable)
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                mem = _device_mem_gib()
                mem_str = f" mem: {mem:.2f}GiB" if mem is not None else ""
                if total:
                    eta = iter_time.global_avg * (total - i)
                    progress = (f"[{i}/{total}] eta: "
                                f"{datetime.timedelta(seconds=int(eta))}")
                else:
                    progress = f"[{i}]"
                print(f"{header} {progress} {self} time: {iter_time} "
                      f"data: {data_time}{mem_str}")
            end = time.time()
        elapsed = datetime.timedelta(seconds=int(time.time() - start))
        print(f"{header} Total time: {elapsed}")


class JsonlLogger:
    """Per-epoch ``log.txt`` JSON lines (logging.py:149)."""

    def __init__(self, output_dir: str, filename: str = "log.txt"):
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        self.path = Path(output_dir) / filename

    def write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
