"""Operators of the port over torch tensors."""

from . import cast_string  # noqa: F401
from . import decimal  # noqa: F401
from . import zorder  # noqa: F401
from . import row_conversion  # noqa: F401
from . import map_utils  # noqa: F401
from . import sort  # noqa: F401
from . import aggregate  # noqa: F401
from . import join  # noqa: F401
from . import get_json_object  # noqa: F401
from . import parquet_reader  # noqa: F401
from . import filter  # noqa: F401
