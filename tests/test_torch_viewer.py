"""The port's viewer (``neusky_torch/viewer.py``) against the JAX package's
(``neusky_tpu/viewer.py``) on the CPU: every render mode, the click probe
and the HTTP round trip (mirror of ``tests/test_viewer.py``), at 12 × 12
pixels from the same converted parameters of the tiny recipe, its DDF's
FiLM inputs in float32 (the bf16 path is held by
``tests/test_torch_joint_slice.py``).

JAX's shadow map (``render_features.render_shadow_map``) runs under
``jax.jit`` (``torch_parity.jitted``): run eagerly it compiles each
primitive on its own.  Tolerance: every image to 2e-5 absolute (float32
sums in another order; a colormap only reads its input).
"""

import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neusky_tpu import viewer as j_viewer
from neusky_tpu.engine import render_features as j_rf
from neusky_tpu.models.neusky import NeuSkyModel as JModel

from neusky_torch import viewer as t_viewer
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.utils.viz import PNG_SIGNATURE, load_png
from test_torch_render_features import fp32_tiny
from torch_parity import jax_to_torch_params, jitted, one_torch_thread, to_torch_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RES = 12
ATOL = 2e-5
BASE_Q = {"az": ["10"], "el": ["25"], "dist": ["1.2"], "saz": ["45"], "sel": ["45"], "thr": ["0.5"], "sig": ["50"]}


@pytest.fixture(scope="module")
def states():
    cfg_j = fp32_tiny()
    jm = JModel(cfg_j)
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))
    lat = params_j["eval_latents"]["eval_latents"]
    params_j["eval_latents"]["eval_latents"] = jnp.asarray(
        0.5 * np.random.default_rng(3).normal(size=lat.shape), jnp.float32)
    tm = TModel(to_torch_config(cfg_j), device="cpu")
    eager = j_rf.render_shadow_map
    with pytest.MonkeyPatch.context() as mp:
        # the JAX viewer imports render_shadow_map when it renders
        mp.setattr(j_rf, "render_shadow_map", lambda model, *a, **kw: jitted(eager, model, *a, **kw))
        yield (j_viewer.ViewerState(jm, params_j, resolution=RES),
               t_viewer.ViewerState(tm, jax_to_torch_params(params_j), resolution=RES))


@pytest.mark.parametrize("mode", t_viewer.MODES)
def test_render_modes_match_jax(states, mode):
    j_state, t_state = states
    got = t_state.render({**BASE_Q, "mode": [mode]})
    want = np.asarray(j_state.render({**BASE_Q, "mode": [mode]}))
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_click_probe_matches_jax(states):
    """The pixel unprojected through the rendered depth, the sky visibility
    of that point as a colormapped equirect map [32, 64, 3] in [0, 1]."""
    j_state, t_state = states
    q = {**BASE_Q, "px": ["0.5"], "py": ["0.4"], "thr": ["0.1"], "sig": ["5"]}
    got = t_state.probe(q)
    assert got.shape == (32, 64, 3) and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, np.asarray(j_state.probe(q)), rtol=0, atol=ATOL)


def test_http_roundtrip(states, tmp_path):
    """The page, one render (512 × 512) and one probe (128 × 64) through the
    real HTTP stack on 127.0.0.1 at port 0; the PNGs decode to the images
    the state renders, enlarged; an unknown path is a 404, a render error
    a 500 with its message."""
    t_state = states[1]
    server = ThreadingHTTPServer(("127.0.0.1", 0), t_viewer.make_handler(t_state))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        assert b"neusky-torch viewer" in urllib.request.urlopen(f"{url}/", timeout=120).read()
        served = {}
        for path, shape in (("/render", (512, 512, 3)), ("/probe", (64, 128, 3))):
            body = urllib.request.urlopen(f"{url}{path}?mode=rgb&az=10&el=25&dist=1.2&px=0.5&py=0.5",
                                          timeout=600).read()
            assert body[:8] == PNG_SIGNATURE
            (tmp_path / "x.png").write_bytes(body)
            served[path] = load_png(str(tmp_path / "x.png"))
            assert served[path].shape == shape
        rows = ((np.arange(512) + 0.5) * RES / 512).astype(int)
        want = np.clip(t_state.render({**BASE_Q, "mode": ["rgb"]}) * 255, 0, 255).astype(np.uint8)[rows][:, rows]
        np.testing.assert_array_equal(served["/render"], want)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(f"{url}/nothing", timeout=60)
        with pytest.raises(urllib.error.HTTPError, match="500") as err:
            urllib.request.urlopen(f"{url}/render?mode=rgb&az=x", timeout=60)
        assert b"ValueError" in err.value.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
