from cusp_autotuned_tpu.utils.exceptions import (
    CuspException, FormatException, FormatConversionException,
    NotImplementedException, InvalidInputException, RuntimeException,
)
from cusp_autotuned_tpu.utils.padding import (
    LANE, round_up, pad_to, pad_axis_to,
)
