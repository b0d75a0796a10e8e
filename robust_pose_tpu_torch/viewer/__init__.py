"""Host-side viewers of the inference CLI's ``--viewer``: ``viewer2d``
(matplotlib panels), ``viewer3d`` and ``view_renderer`` (open3d). Each
imports its library when it is made."""
