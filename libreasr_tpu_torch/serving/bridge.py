"""WebSocket <-> gRPC bridge (the JAX package's serving/bridge.py,
the port's own copy).

The wire protocol the web and ESP32 clients speak: binary WS frames
`[4B lang ascii][4B f32 sample-rate][f32 pcm ...]`, one gRPC streaming
call per connection with send/recv queues and a 2 s idle timeout, plus
static file serving for the web client build.

Usage: python -m libreasr_tpu_torch.serving.bridge [--port 8080]
"""

from __future__ import annotations

import argparse
import queue
import struct
import threading

from . import proto

WS_PATH = "/asupersecretwebsocketpath345"  # the web client's path
TIMEOUT_S = 2.0
LANG_PORTS = {"en": 50051, "de": 50052, "fr": 50053}


def grpc_thread_func(q_recv, q_send, lang: str, host: str = "localhost"):
    """Per-connection gRPC streaming thread: pulls Audio from q_recv (a
    2 s timeout ends the stream), pushes Transcript text into q_send."""
    import grpc

    port = LANG_PORTS.get(lang, 50051)
    channel = grpc.insecure_channel(f"{host}:{port}")
    call = channel.stream_stream(
        proto.METHOD_TRANSCRIBE_STREAM,
        request_serializer=proto.Audio.SerializeToString,
        response_deserializer=proto.Transcript.FromString,
    )

    def yielder():
        while True:
            try:
                item = q_recv.get(timeout=TIMEOUT_S)
            except queue.Empty:
                return
            if item is None:
                return
            yield item

    try:
        for transcript in call(yielder()):
            q_send.put(transcript.data)
    except Exception as e:  # stream ended / server gone
        q_send.put(None)
        print(f"[api-bridge] grpc thread ended: {e}")
    finally:
        channel.close()


def parse_frame(raw: bytes):
    """[4B lang][4B f32 sr][payload f32 pcm]."""
    lang = raw[:4].decode("ascii", errors="replace").strip("\x00 ")
    (sr,) = struct.unpack("<f", raw[4:8])
    return lang, int(sr), raw[8:]


def make_app(static_path: str | None = None, grpc_host: str = "localhost"):
    import tornado.web
    import tornado.websocket

    class WebSocket(tornado.websocket.WebSocketHandler):
        def check_origin(self, origin):
            return True

        def open(self):
            self.q_recv: queue.Queue = queue.Queue()
            self.q_send: queue.Queue = queue.Queue()
            self.thread = None
            self.ioloop = tornado.ioloop.IOLoop.current()
            self._pump = tornado.ioloop.PeriodicCallback(self._drain, 50)
            self._pump.start()

        def _ensure_thread(self, lang):
            if self.thread is None or not self.thread.is_alive():
                self.q_recv = queue.Queue()
                self.thread = threading.Thread(
                    target=grpc_thread_func,
                    args=(self.q_recv, self.q_send, lang, grpc_host),
                    daemon=True,
                )
                self.thread.start()

        def _drain(self):
            while True:
                try:
                    text = self.q_send.get_nowait()
                except queue.Empty:
                    return
                if text:
                    try:
                        self.write_message(text)
                    except Exception:
                        return

        def on_message(self, raw):
            if not isinstance(raw, bytes) or len(raw) < 8:
                return
            lang, sr, payload = parse_frame(raw)
            self._ensure_thread(lang or "en")
            self.q_recv.put(proto.Audio(data=payload, sr=sr))

        def on_close(self):
            self._pump.stop()
            self.q_recv.put(None)

    routes = [(WS_PATH, WebSocket)]
    if static_path:
        routes.append(
            (
                r"/(.*)",
                tornado.web.StaticFileHandler,
                {"path": static_path, "default_filename": "index.html"},
            )
        )
    return tornado.web.Application(routes)


def main(argv=None):
    import tornado.ioloop

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--static", default=None)
    p.add_argument("--grpc-host", default="localhost")
    a = p.parse_args(argv)
    app = make_app(a.static, a.grpc_host)
    app.listen(a.port)
    print(f"[api-bridge] ws on :{a.port}{WS_PATH}")
    tornado.ioloop.IOLoop.current().start()


if __name__ == "__main__":
    main()
