"""Check the wire transport's vectored send on this machine's kernel.

    python3 scripts/wire_probe.py

Sends 1,300 buffers (more than the transport's 512-entry iovec cap) over
a socketpair whose send buffer is 16 KiB, so that ``vectored_sendall``
splits the send across ``sendmsg`` calls and waits on ``loop.add_writer``
between them; then queues 600 frames on a ``CoalescedWriter`` while the
wire is held, so that they leave in vectored batches. Prints the kernel's
release, whether both byte streams arrived equal, and the batches' mean
and largest frame counts; exits 1 when a stream differs. Imports only the
port's transport."""

import asyncio
import os
import platform
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from curvine_tpu_torch.common.metrics import MetricsRegistry  # noqa: E402
from curvine_tpu_torch.rpc import transport  # noqa: E402
from curvine_tpu_torch.rpc.frame import Message  # noqa: E402


async def drain(loop, sock, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        got = await loop.sock_recv(sock, 1 << 20)
        if not got:
            break
        out += got
    return bytes(out)


async def main() -> int:
    loop = asyncio.get_running_loop()
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16 * 1024)
    try:
        bufs = [bytes([i % 256]) * (1000 + i) for i in range(1300)]
        want = b"".join(bufs)
        recv = asyncio.ensure_future(drain(loop, b, len(want)))
        await transport.vectored_sendall(loop, a, bufs)
        sent_equal = await recv == want
        print(f"kernel {platform.release()}: {len(bufs)} buffers "
              f"(iovec cap {transport._IOV_CAP}), {len(want):,} bytes, "
              f"equal {sent_equal}", flush=True)

        m = MetricsRegistry("probe")
        w = transport.CoalescedWriter(a, loop, metrics=m)
        msgs = [Message(code=5, req_id=i,
                        data=bytes(20_000) if i % 3 == 0 else b"x")
                for i in range(600)]
        wire = b"".join(bytes(x) for msg in msgs for x in msg.encode())
        async with w._io_lock:          # the held wire queues every frame
            sends = [asyncio.ensure_future(w.send(msg)) for msg in msgs]
            await asyncio.sleep(0)
        recv = asyncio.ensure_future(drain(loop, b, len(wire)))
        await asyncio.gather(*sends)
        batched_equal = await recv == wire
        h = m.histograms["rpc.send_batch_frames"]
        print(f"writer: {len(msgs)} frames in {h.count} batches, mean "
              f"{h.sum / h.count:.1f} frames, largest {h.max:.0f}, equal "
              f"{batched_equal}", flush=True)
        await w.aclose()
    finally:
        a.close()
        b.close()
    return 0 if sent_equal and batched_equal else 1


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
