from dosma_tpu_torch.gui.gui_utils.console_output import WidgetLogger  # noqa: F401
from dosma_tpu_torch.gui.gui_utils.filedialog_reader import FileDialogReader  # noqa: F401
from dosma_tpu_torch.gui.gui_utils.forms import (  # noqa: F401
    FieldSpec,
    action_fields,
    build_cli_string,
    is_filepath_param,
    parse_value,
    segmentation_fields,
)
