"""Dataset exporters (counterpart of dvmvs_tpu/data/exporters/): raw dataset
formats into the canonical scene layout (images/*.png RGB, depth/*.png
uint16 mm, poses.txt flattened 4x4 camera-to-world per line, K.txt 3x3),
without OpenCV: images are read by ``data/io.py::read_image`` /
``read_rgb`` (PNG, and baseline JPEG through ``data/jpeg.py``) and written by
``write_png``. The command lines export scenes in spawned worker processes
(``data/scene_folders.spawn_pool``).

Reference exporters: dataset/{scannet,7scenes,tum-rgbd,rgbdscenes,
augmented-iclnuim}-export/.
"""

# zlib level of the exported PNGs (cv2.IMWRITE_PNG_COMPRESSION 3 in the reference)
PNG_LEVEL = 3
