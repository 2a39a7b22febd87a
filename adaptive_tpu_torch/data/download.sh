#!/usr/bin/env bash
# MS-COCO 2014 download (reference code_src/data/download.sh:1-11 parity).
# Usage: download.sh [target_dir]
# COCO_IMAGES_URL / COCO_ANNOTATIONS_URL override the mirror base URLs
# (defaults: the official cocodataset.org endpoints). The unzip/layout logic
# is smoke-tested against a local fixture server in tests/test_data_stages.py
# (this copy in tests/test_torch_detection.py).
set -euo pipefail
DIR="${1:-data/MSCOCO}"
IMAGES_URL="${COCO_IMAGES_URL:-http://images.cocodataset.org/zips}"
ANN_URL="${COCO_ANNOTATIONS_URL:-http://images.cocodataset.org/annotations}"
mkdir -p "$DIR/annotations"
cd "$DIR"
wget -c "$ANN_URL/annotations_trainval2014.zip"
wget -c "$IMAGES_URL/train2014.zip"
wget -c "$IMAGES_URL/val2014.zip"
unzip -o annotations_trainval2014.zip -d annotations
unzip -o train2014.zip
unzip -o val2014.zip
rm -f annotations_trainval2014.zip train2014.zip val2014.zip
