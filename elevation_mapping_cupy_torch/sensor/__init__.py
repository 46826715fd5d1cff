from .pointcloud import create_pcl_from_image, PointcloudParameter  # noqa: F401
from .utils import encode_max, decode_max  # noqa: F401
