from goldfish_jax.geometry.nurbs import NURBS  # noqa: F401
from goldfish_jax.geometry import cadkit  # noqa: F401
from goldfish_jax.geometry.igs_io import (  # noqa: F401
    TrimmedSurface,
    read_igs_curves,
    read_igs_file,
    read_igs_trimmed,
    write_igs_file,
)
from goldfish_jax.geometry.step_io import (  # noqa: F401
    read_step_assembly,
    read_step_file,
    write_step_assembly,
    write_step_file,
)
from goldfish_jax.geometry.trim import (  # noqa: F401
    apply_trim,
    points_in_polygon,
    sample_loop,
    trim_mask,
)
