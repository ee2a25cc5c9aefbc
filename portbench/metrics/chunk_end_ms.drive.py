"""Host ms of a chunk's end in the window: the host read of the chunk's
outputs and the scoring (``cli.drive``'s chunk end), timed by the harness."""


def read(rec):
    return rec.get("chunk_end_ms")
