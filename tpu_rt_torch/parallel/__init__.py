from .mesh import make_mesh, render_sharded  # noqa: F401
from .multihost import (  # noqa: F401
    dcn_bytes_per_displayed_frame,
    group_devices_by_host,
    make_multihost_mesh,
    sample_groups_are_host_local,
)
