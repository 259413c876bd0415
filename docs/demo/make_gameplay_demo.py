"""Regenerate docs/demo gameplay images: a simulated platformer
playthrough (utils.gameplay) through the full pipeline.

Run from the repo root:  python docs/demo/make_gameplay_demo.py
Writes gp_frame*.png, gp_map.png, gp_world.png next to this file.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[2]))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from remap_tpu.utils.runtime import setup_cache  # noqa: E402

setup_cache()

from remap_tpu.config import PipelineConfig  # noqa: E402
from remap_tpu.core import palette  # noqa: E402
from remap_tpu.pipeline import builder  # noqa: E402
from remap_tpu.utils import gameplay  # noqa: E402

HERE = pathlib.Path(__file__).parent


def save(name: str, native: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(palette.NATIVE_TO_RGB[native]).save(str(HERE / name))
    print("wrote", HERE / name)


def main() -> None:
    session = gameplay.play_session(seed=3, n_frames=220,
                                    frame_hw=(312, 388))
    save("gp_frame0.png", session.frames[0])
    save("gp_frame150.png", session.frames[150])

    result = builder.build_from_frames(
        [np.asarray(f) for f in session.frames],
        PipelineConfig(screen_width=388, screen_height=312),
    )
    assert len(result.maps) == 1, [m.shape for m in result.maps]
    save("gp_map.png", result.maps[0])

    cam = np.array(session.camera)
    y0, y1 = cam[:, 1].min(), cam[:, 1].max() + (312 - 24 - 16)
    x0, x1 = cam[:, 0].min(), cam[:, 0].max() + (388 - 16)
    save("gp_world.png", session.world[y0:y1, x0:x1])


if __name__ == "__main__":
    main()
