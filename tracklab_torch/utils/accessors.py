"""Pandas extension accessors for detection DataFrames (counterpart of
tracklab_tpu.utils.accessors, kept as the port's own copy).

``df.bbox.ltwh()/.ltrb()/.xywh()/.conf()`` and
``df.keypoints.xyc()/.xy()/.conf()/.in_bbox_coord()`` on DataFrames (a
column of array-valued cells) and on single Series rows.

The names ``bbox`` and ``keypoints`` are process-wide: where the JAX
package registers its own accessors in the same process (the tests import
both), the later registration wins. Both behave alike, so either serves;
pandas' warning about the override is silenced here.
"""
from __future__ import annotations

import warnings

import pandas as pd

from tracklab_torch.utils import coordinates as C

__all__ = ["BBoxDataFrameAccessor", "BBoxSeriesAccessor",
           "KeypointsDataFrameAccessor", "KeypointsSeriesAccessor"]


class BBoxDataFrameAccessor:
    def __init__(self, df: pd.DataFrame):
        self._df = df

    def ltwh(self, image_shape=None, rounded=False):
        return self._df["bbox_ltwh"].apply(
            lambda x: C.sanitize_bbox_ltwh(x, image_shape, rounded))

    def ltrb(self, image_shape=None, rounded=False):
        return self._df["bbox_ltwh"].apply(
            lambda x: C.sanitize_bbox_ltrb(
                C.ltwh_to_ltrb(x), image_shape, rounded))

    def xywh(self, image_shape=None, rounded=False):
        return self._df["bbox_ltwh"].apply(
            lambda x: C.sanitize_bbox_ltwh(
                C.ltwh_to_xywh(x), image_shape, rounded))

    def conf(self):
        return self._df["bbox_conf"]


class BBoxSeriesAccessor:
    def __init__(self, s: pd.Series):
        self._s = s

    def ltwh(self, image_shape=None, rounded=False):
        return C.sanitize_bbox_ltwh(self._s["bbox_ltwh"], image_shape,
                                    rounded)

    def ltrb(self, image_shape=None, rounded=False):
        return C.sanitize_bbox_ltrb(
            C.ltwh_to_ltrb(self._s["bbox_ltwh"]), image_shape, rounded)

    def xywh(self, image_shape=None, rounded=False):
        return C.sanitize_bbox_ltwh(
            C.ltwh_to_xywh(self._s["bbox_ltwh"]), image_shape, rounded)

    def conf(self):
        return self._s["bbox_conf"]


class KeypointsDataFrameAccessor:
    def __init__(self, df: pd.DataFrame):
        self._df = df

    def xyc(self, image_shape=None, rounded=False):
        return self._df["keypoints_xyc"].apply(
            lambda x: C.sanitize_keypoints(x, image_shape, rounded))

    def xy(self, image_shape=None, rounded=False):
        return self._df["keypoints_xyc"].apply(
            lambda x: C.sanitize_keypoints(x, image_shape, rounded)[:, :2])

    def conf(self):
        return self._df["keypoints_xyc"].apply(lambda x: x[:, 2])

    def in_bbox_coord(self, bbox_ltwh):
        return self._df["keypoints_xyc"].apply(
            lambda x: C.kp_img_to_kp_bbox(x, bbox_ltwh))


class KeypointsSeriesAccessor:
    def __init__(self, s: pd.Series):
        self._s = s

    def xyc(self, image_shape=None, rounded=False):
        return C.sanitize_keypoints(self._s["keypoints_xyc"], image_shape,
                                    rounded)

    def xy(self, image_shape=None, rounded=False):
        return C.sanitize_keypoints(
            self._s["keypoints_xyc"], image_shape, rounded)[:, :2]

    def conf(self):
        return self._s["keypoints_xyc"][:, 2]

    def in_bbox_coord(self, bbox_ltwh):
        return C.kp_img_to_kp_bbox(self._s["keypoints_xyc"], bbox_ltwh)


with warnings.catch_warnings():
    warnings.filterwarnings("ignore", "registration of accessor",
                            UserWarning)
    for _register, _name, _cls in (
            (pd.api.extensions.register_dataframe_accessor, "bbox",
             BBoxDataFrameAccessor),
            (pd.api.extensions.register_series_accessor, "bbox",
             BBoxSeriesAccessor),
            (pd.api.extensions.register_dataframe_accessor, "keypoints",
             KeypointsDataFrameAccessor),
            (pd.api.extensions.register_series_accessor, "keypoints",
             KeypointsSeriesAccessor)):
        _register(_name)(_cls)
