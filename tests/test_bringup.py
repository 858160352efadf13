"""The GPU bring-up contract on the CPU harness: the compile cache's
location, chip_smoke.py's refusal to run without a GPU and its result
line, a package with one implementation per operation, and the
standard-library API client
over a real socket."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, cwd=REPO, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_setup_jax_cache_dir(tmp_path, env_dir):
    """setup_jax uses JAX_COMPILATION_CACHE_DIR when it is set (and sets
    nothing itself), and <repo>/.jax_cache otherwise."""
    extra = {}
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        extra["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("from videoquery.core.jaxsetup import setup_jax; import jax; "
            "print(setup_jax()); print(jax.config.jax_compilation_cache_dir)")
    out = _run(["-c", code], extra)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    assert returned == configured == want


def test_chip_smoke_refuses_cpu():
    """No GPU: exit nonzero before any phase, and no result line."""
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_needs_the_repository(tmp_path):
    """Alone in a directory, the script fails without printing a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line_contract():
    sys.path.insert(0, REPO)
    import chip_smoke

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_package_has_no_other_platform_code():
    """No module imports the other accelerator's Pallas dialect or branches
    on its platform name: one implementation per operation."""
    other = "tp" + "u"  # spelled apart so this file does not match itself
    pattern = re.compile("|".join([
        r"pallas\." + other, "pl" + other, f"force_{other}_interpret_mode",
        r'startswith\("' + other.upper() + r'"\)', f'"{other}" in',
        "flow" + "_impl"]))
    hits = []
    for root, _dirs, files in os.walk(os.path.join(REPO, "videoquery")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for i, line in enumerate(f, 1):
                        if pattern.search(line):
                            hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, hits


def test_urllib_client_against_fake_api(monkeypatch):
    """HTTPTransport (urllib only) authenticates, lists with query params,
    creates with a JSON body, patches, uploads a multipart file, and reads
    back JSON error bodies, all over a real socket."""
    from http.server import ThreadingHTTPServer

    from videoquery.service.client import ActionClient, HTTPTransport
    from videoquery.testing import serve_fake_api as fake
    from videoquery.testing.fake_api import FakeAPI

    api = FakeAPI()
    monkeypatch.setattr(fake, "api", api)
    monkeypatch.setenv("API_CLIENT_USERNAME", "u")
    monkeypatch.setenv("API_CLIENT_PASSWORD", "p")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), fake.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        client = ActionClient(HTTPTransport(
            f"http://127.0.0.1:{srv.server_address[1]}/"))
        video = client.action(["videos", "create"],
                              {"name": "v1", "path": "/data/v1.mp4"})
        assert api.videos[video["id"]]["name"] == "v1"
        listed = client.action(["videos", "list"], {"name": "v1"})
        rows = listed["results"] if isinstance(listed, dict) else listed
        assert [r["id"] for r in rows] == [video["id"]]
        ss = api.add_search_set("s", [])
        q = api.add_query("q", video["id"], 1, None, ss["id"])
        client.action(["queries", "partial_update"],
                      {"id": q["id"], "process_state": 2})
        assert api.queries[q["id"]]["process_state"] == 2
        report = io.BytesIO(b"clip,score\n1,0.5")
        report.name = "report.csv"
        client.action(["queries", "partial_update"],
                      {"id": q["id"], "final_report_file": report},
                      encoding="multipart/form-data")
        assert api.uploaded_reports[q["id"]] == b"clip,score\n1,0.5"
        missing = client.action(["queries", "read"], {"id": 10 ** 6})
        assert "not found" in missing["detail"]
    finally:
        srv.shutdown()
        srv.server_close()
