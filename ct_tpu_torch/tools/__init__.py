"""Command-line tools of the port: ``diff_detections`` (agreement of two
``detections.pkl`` files) and ``trace_summary`` (the device's busy share
in a ``--profile-dir`` trace)."""
