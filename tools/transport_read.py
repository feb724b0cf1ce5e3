"""How long does one frame take to arrive over the multi-host transport?

Sends one message of each size over an AF_UNIX
``multiprocessing.connection`` pair (the socket fabric's streams), with
``Connection.send_bytes`` on the sending side, and reads it on the other
side two ways: ``Connection.recv_bytes`` (asks the kernel for every byte
still missing on each read) and the transport's ``_recv_msg`` (bounded
reads of ``_READ_CHUNK``). Prints the seconds of each, and the seconds
to pack and unpack a frame of a float32 array of that size.

    python3 tools/transport_read.py 128 539      # sizes in MiB

Needs no card. 539 MiB is smollm-135m's flat gradient buffer.
"""
import os
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from multiprocessing.connection import Client, Listener  # noqa: E402

from repro_torch.runtime_dist import transport as T  # noqa: E402


def read_seconds(path: str, lst, nbytes: int, reader) -> float:
    """Seconds from the start of ``send_bytes`` to the message read."""
    out = {}

    def serve():
        conn = lst.accept()
        out["n"] = len(reader(conn))
        out["t"] = time.perf_counter()
        conn.close()
    th = threading.Thread(target=serve)
    th.start()
    tx = Client(path, "AF_UNIX")
    blob = b"\x01" * nbytes
    t0 = time.perf_counter()
    tx.send_bytes(blob)
    th.join()
    tx.close()
    assert out["n"] == nbytes, out
    return out["t"] - t0


def main() -> int:
    sizes = [int(a) for a in sys.argv[1:]] or [128, 539]
    path = os.path.join(tempfile.mkdtemp(prefix="transport-read-"), "s")
    lst = Listener(path, "AF_UNIX")
    for mib in sizes:
        n = mib << 20
        arr = np.ones(n // 4, np.float32)
        t0 = time.perf_counter()
        frame = T._pack_frame(0, 0, "red", (0, 0, 0, arr))
        t1 = time.perf_counter()
        T._unpack_frame(frame)
        t2 = time.perf_counter()
        del frame
        std = read_seconds(path, lst, n, lambda c: c.recv_bytes())
        bounded = read_seconds(path, lst, n, T._recv_msg)
        print(f"{mib} MiB: recv_bytes {std:.3f} s, _recv_msg (reads of "
              f"{T._READ_CHUNK >> 20} MiB) {bounded:.3f} s; a frame of "
              f"that many f32 packed in {t1 - t0:.3f} s, unpacked in "
              f"{t2 - t1:.3f} s", flush=True)
    lst.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
