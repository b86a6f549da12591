"""Command-line tools of the port: ``diff_detections`` (agreement of two
``detections.pkl`` files), ``trace_summary`` (the device's busy share in a
``--profile-dir`` trace) and ``coco_fixture`` (the synthetic COCO-60
tree)."""
