"""CodaLab submission packaging for the QVHighlights test server; a copy of
``univtg_tpu/tools/codalab.py``.

Reference: eval/submit_codalab.py -- val+test prediction jsonls zipped as
hl_{val,test}_submission.jsonl.
"""
from __future__ import annotations

import os
import zipfile


def package_submission(val_path: str, test_path: str, out_zip: str) -> str:
    os.makedirs(os.path.dirname(out_zip) or ".", exist_ok=True)
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(val_path, "hl_val_submission.jsonl")
        z.write(test_path, "hl_test_submission.jsonl")
    return out_zip
