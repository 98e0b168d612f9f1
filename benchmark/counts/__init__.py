"""Operations, bytes and FLOPs from shapes alone: the yardstick of the
roofline shares and of ``mfu``. Nothing here reads the program."""
