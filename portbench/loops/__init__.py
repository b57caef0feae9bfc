"""One loop a traffic kind: ``loops/<kind>.py`` holds ``run`` and ``check``
of the mixes whose file says ``"kind": "<kind>"``, found by that name."""
