"""The port's ``utils/logging.py`` extras against the JAX module's:
``cost_analysis`` (torch's FlopCounterMode against XLA's cost analysis),
``profile_trace`` (a torch.profiler Chrome trace) and ``CloudLog`` (the
same sender, against a local ``http.server``, as
``tests/test_cli_end2end.py`` ``test_cloud_log`` checks JAX's)."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from image_restoration_tpu_torch.utils import logging as L


def _stack(rng):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((3, 3, 3, 8), (3, 3, 8, 8), (1, 1, 8, 3))]


def _jax_fn(ks, act, padding):
    def fn(x):
        for k in ks:
            x = jax.lax.conv_general_dilated(
                x, jnp.asarray(k), (1, 1), padding,
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            if act:
                x = jax.nn.relu(x)
        return x
    return fn


def _torch_fn(ks, act, padding):
    ws = [torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
          for k in ks]

    def fn(x):
        for w in ws:
            x = F.conv2d(x, w, padding=w.shape[-1] // 2 if padding == "SAME"
                         else 0)
            if act:
                x = F.relu(x)
        return x
    return fn


def test_cost_analysis_conv_flops_match_xla():
    """Both count 2 FLOPs a multiply-add of a convolution. Without padding
    the two counts agree exactly. With SAME padding XLA counts only the
    taps that fall inside the input, and torch's counter every tap of
    every output (the zero padding too). With a ReLU after each conv XLA
    also counts the elementwise ops and the port does not: the port's
    count stays the convolutions'."""
    from image_restoration_tpu.utils.logging import cost_analysis

    ks = _stack(np.random.default_rng(0))
    x = np.random.default_rng(1).random((2, 16, 12, 3), dtype=np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    want = cost_analysis(_jax_fn(ks, False, "VALID"), jnp.asarray(x))
    got = L.cost_analysis(_torch_fn(ks, False, "VALID"), xt)
    macs = 2 * (14 * 10 * 9 * 3 * 8 + 12 * 8 * 9 * 8 * 8 + 12 * 8 * 8 * 3)
    assert got == {"flops": 2.0 * macs} and want["flops"] == got["flops"]
    # SAME: 3x3 taps inside a 16x12 map: (3*16-2) x (3*12-2) of 9*16*12
    got = L.cost_analysis(_torch_fn(ks, False, "SAME"), xt)
    want = cost_analysis(_jax_fn(ks, False, "SAME"), jnp.asarray(x))
    assert got["flops"] == 2.0 * 2 * 16 * 12 * (9 * 3 * 8 + 9 * 8 * 8 + 8 * 3)
    assert want["flops"] == 2.0 * 2 * (46 * 34 * (3 * 8 + 8 * 8) + 16 * 12 * 8 * 3)
    with_act = L.cost_analysis(_torch_fn(ks, True, "SAME"), xt)
    assert with_act == got
    assert cost_analysis(_jax_fn(ks, True, "SAME"),
                         jnp.asarray(x))["flops"] > want["flops"]


def test_cost_analysis_counts_a_model():
    from image_restoration_tpu_torch.models import get_model

    m = get_model("restormer", dim=8, num_blocks=(1, 1, 1, 1),
                  num_refinement_blocks=1, heads=(1, 2, 4, 8)).eval()
    got = L.cost_analysis(m, torch.rand(1, 3, 32, 32))
    assert set(got) == {"flops"} and got["flops"] > 0


def test_profile_trace_writes_a_trace(tmp_path):
    with L.profile_trace(str(tmp_path)) as prof:
        torch.relu(torch.rand(64, 64) @ torch.rand(64, 64))
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.load(open(tmp_path / files[0]))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert prof.key_averages()


def test_cloud_log():
    import http.server
    import threading
    from urllib.parse import parse_qs, urlparse

    L.CloudLog(on=False, url="http://127.0.0.1:1/x").sendLog("a", "b")
    L.CloudLog(on=True, url="").sendLog("a", "b")
    got = {}

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            got.update(parse_qs(urlparse(self.path).query))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        log = L.CloudLog(on=True, url=f"http://127.0.0.1:{srv.server_port}/log")
        log.sendLog("loss=0.5 epoch 3", "exp/a b")
        for _ in range(100):
            if got:
                break
            time.sleep(0.05)
        assert got.get("name") == ["exp/a b"]
        assert got.get("content") == ["loss=0.5 epoch 3"]
    finally:
        srv.shutdown()
    bad = L.CloudLog(on=True, url="http://127.0.0.1:1/x", timeout=0.2)
    bad.sendLog("x", "y")
    time.sleep(0.3)


def test_cloud_log_queue_drops_the_oldest():
    log = L.CloudLog(on=False)
    log.on = True  # a queue with no worker: what stays is what was kept
    import queue

    log._q = queue.Queue(maxsize=2)
    for i in range(4):
        log.sendLog(str(i), "n")
    assert [log._q.get_nowait()[0] for _ in range(2)] == ["2", "3"]
