"""DICOM tag dictionary (subset) — keyword ↔ (tag, VR) lookups.

Covers every tag the reference framework touches (grouping/sorting tags,
image-plane module, pixel module, MR timing tags, qDESS private tags at
``0x001910B6/B7`` — see ``dosma/scan_sequences/mri/qdess.py:44-45``)
plus the common patient/study/series identifiers.
"""

from __future__ import annotations

# keyword -> (tag_int, VR, VM_is_multi)
DICT = {
    # File meta (group 0002)
    "FileMetaInformationGroupLength": (0x00020000, "UL"),
    "FileMetaInformationVersion": (0x00020001, "OB"),
    "MediaStorageSOPClassUID": (0x00020002, "UI"),
    "MediaStorageSOPInstanceUID": (0x00020003, "UI"),
    "TransferSyntaxUID": (0x00020010, "UI"),
    "ImplementationClassUID": (0x00020012, "UI"),
    "ImplementationVersionName": (0x00020013, "SH"),
    # Identification
    "SpecificCharacterSet": (0x00080005, "CS"),
    "ImageType": (0x00080008, "CS"),
    "SOPClassUID": (0x00080016, "UI"),
    "SOPInstanceUID": (0x00080018, "UI"),
    "StudyDate": (0x00080020, "DA"),
    "SeriesDate": (0x00080021, "DA"),
    "AcquisitionDate": (0x00080022, "DA"),
    "ContentDate": (0x00080023, "DA"),
    "StudyTime": (0x00080030, "TM"),
    "SeriesTime": (0x00080031, "TM"),
    "AcquisitionTime": (0x00080032, "TM"),
    "ContentTime": (0x00080033, "TM"),
    "AccessionNumber": (0x00080050, "SH"),
    "Modality": (0x00080060, "CS"),
    "Manufacturer": (0x00080070, "LO"),
    "InstitutionName": (0x00080080, "LO"),
    "ReferringPhysicianName": (0x00080090, "PN"),
    "StationName": (0x00081010, "SH"),
    "StudyDescription": (0x00081030, "LO"),
    "SeriesDescription": (0x0008103E, "LO"),
    "ManufacturerModelName": (0x00081090, "LO"),
    # Patient
    "PatientName": (0x00100010, "PN"),
    "PatientID": (0x00100020, "LO"),
    "PatientBirthDate": (0x00100030, "DA"),
    "PatientSex": (0x00100040, "CS"),
    "PatientAge": (0x00101010, "AS"),
    "PatientWeight": (0x00101030, "DS"),
    # MR acquisition
    "BodyPartExamined": (0x00180015, "CS"),
    "ScanningSequence": (0x00180020, "CS"),
    "SequenceVariant": (0x00180021, "CS"),
    "ScanOptions": (0x00180022, "CS"),
    "MRAcquisitionType": (0x00180023, "CS"),
    "SliceThickness": (0x00180050, "DS"),
    "RepetitionTime": (0x00180080, "DS"),
    "EchoTime": (0x00180081, "DS"),
    "InversionTime": (0x00180082, "DS"),
    "NumberOfAverages": (0x00180083, "DS"),
    "ImagingFrequency": (0x00180084, "DS"),
    "ImagedNucleus": (0x00180085, "SH"),
    "EchoNumbers": (0x00180086, "IS"),
    "MagneticFieldStrength": (0x00180087, "DS"),
    "SpacingBetweenSlices": (0x00180088, "DS"),
    "NumberOfPhaseEncodingSteps": (0x00180089, "IS"),
    "EchoTrainLength": (0x00180091, "IS"),
    "PercentSampling": (0x00180093, "DS"),
    "PercentPhaseFieldOfView": (0x00180094, "DS"),
    "PixelBandwidth": (0x00180095, "DS"),
    "SoftwareVersions": (0x00181020, "LO"),
    "ProtocolName": (0x00181030, "LO"),
    "TriggerTime": (0x00181060, "DS"),
    "ReconstructionDiameter": (0x00181100, "DS"),
    "GantryDetectorTilt": (0x00181120, "DS"),
    "ReceiveCoilName": (0x00181250, "SH"),
    "TransmitCoilName": (0x00181251, "SH"),
    "AcquisitionMatrix": (0x00181310, "US"),
    "InPlanePhaseEncodingDirection": (0x00181312, "CS"),
    "FlipAngle": (0x00181314, "DS"),
    "VariableFlipAngleFlag": (0x00181315, "CS"),
    "SAR": (0x00181316, "DS"),
    "PatientPosition": (0x00185100, "CS"),
    # Relationship / image plane
    "StudyInstanceUID": (0x0020000D, "UI"),
    "SeriesInstanceUID": (0x0020000E, "UI"),
    "StudyID": (0x00200010, "SH"),
    "SeriesNumber": (0x00200011, "IS"),
    "AcquisitionNumber": (0x00200012, "IS"),
    "InstanceNumber": (0x00200013, "IS"),
    "ImagePositionPatient": (0x00200032, "DS"),
    "ImageOrientationPatient": (0x00200037, "DS"),
    "FrameOfReferenceUID": (0x00200052, "UI"),
    "Laterality": (0x00200060, "CS"),
    "PatientOrientation": (0x00200020, "CS"),
    "ImagesInAcquisition": (0x00201002, "IS"),
    "PositionReferenceIndicator": (0x00201040, "LO"),
    "SliceLocation": (0x00201041, "DS"),
    "TemporalPositionIdentifier": (0x00200100, "IS"),
    "NumberOfTemporalPositions": (0x00200105, "IS"),
    # Image pixel
    "SamplesPerPixel": (0x00280002, "US"),
    "PhotometricInterpretation": (0x00280004, "CS"),
    "PlanarConfiguration": (0x00280006, "US"),
    "NumberOfFrames": (0x00280008, "IS"),
    "Rows": (0x00280010, "US"),
    "Columns": (0x00280011, "US"),
    "PixelSpacing": (0x00280030, "DS"),
    "ImagerPixelSpacing": (0x00181164, "DS"),

    "BitsAllocated": (0x00280100, "US"),
    "BitsStored": (0x00280101, "US"),
    "HighBit": (0x00280102, "US"),
    "PixelRepresentation": (0x00280103, "US"),
    "LossyImageCompression": (0x00282110, "CS"),
    "LossyImageCompressionRatio": (0x00282112, "DS"),
    "LossyImageCompressionMethod": (0x00282114, "CS"),
    "SmallestImagePixelValue": (0x00280106, "US"),
    "LargestImagePixelValue": (0x00280107, "US"),
    "WindowCenter": (0x00281050, "DS"),
    "WindowWidth": (0x00281051, "DS"),
    "RescaleIntercept": (0x00281052, "DS"),
    "RescaleSlope": (0x00281053, "DS"),
    "RescaleType": (0x00281054, "LO"),
    "PixelData": (0x7FE00010, "OW"),
    # Enhanced multi-frame (PS3.3 C.7.6.16 functional group macros). The
    # reference reads these implicitly through pydicom; our reader promotes
    # them to classic per-slice attributes in ``multiframe.expand_frames``.
    "SharedFunctionalGroupsSequence": (0x52009229, "SQ"),
    "PerFrameFunctionalGroupsSequence": (0x52009230, "SQ"),
    "PixelMeasuresSequence": (0x00289110, "SQ"),
    "FrameContentSequence": (0x00209111, "SQ"),
    "PlanePositionSequence": (0x00209113, "SQ"),
    "PlaneOrientationSequence": (0x00209116, "SQ"),
    "MREchoSequence": (0x00189114, "SQ"),
    "EffectiveEchoTime": (0x00189082, "FD"),
    "PixelValueTransformationSequence": (0x00289145, "SQ"),
    "FrameAcquisitionNumber": (0x00209156, "US"),
    "DimensionIndexValues": (0x00209157, "UL"),
    "StackID": (0x00209056, "SH"),
    "InStackPositionNumber": (0x00209057, "UL"),
    "TemporalPositionIndex": (0x00209128, "UL"),
    "ConcatenationFrameOffsetNumber": (0x00209228, "UL"),
}

# Multi-valued DS/IS/US tags (VM > 1).
MULTIVALUE_KEYWORDS = {
    "ImagePositionPatient",  # VM 3
    "ImageOrientationPatient",  # VM 6
    "PixelSpacing",  # VM 2
    "AcquisitionMatrix",  # VM 4
    "PatientOrientation",  # VM 2
    "ImageType",  # VM 2-n
    "WindowCenter",
    "WindowWidth",
    "EchoNumbers",  # VM 1-n
}

TAG_TO_KEYWORD = {tag: kw for kw, (tag, _vr) in DICT.items()}
KEYWORD_TO_TAG = {kw: tag for kw, (tag, _vr) in DICT.items()}
KEYWORD_TO_VR = {kw: vr for kw, (tag, vr) in DICT.items()}
TAG_TO_VR = {tag: vr for kw, (tag, vr) in DICT.items()}

# Private-tag VRs, applied ONLY when the block's private-creator element
# matches the prefix (pydicom's private-dictionary behavior — an unrelated
# vendor may use the same element for binary data). The GE qDESS spoiler
# gradient area/time tags are what ``QDess.generate_t2_map`` needs
# (``dosma/scan_sequences/mri/qdess.py:44-45``).
PRIVATE_TAG_VR = {
    0x001910B6: ("GEMS_ACQU", "DS"),
    0x001910B7: ("GEMS_ACQU", "DS"),
}

# VRs using 2-byte length in explicit encoding.
SHORT_VRS = {
    "AE", "AS", "AT", "CS", "DA", "DS", "DT", "FL", "FD", "IS", "LO", "LT",
    "PN", "SH", "SL", "SS", "ST", "TM", "UI", "UL", "US",
}
# VRs using 12-byte header (reserved + 4-byte length).
LONG_VRS = {"OB", "OW", "OF", "OD", "OL", "SQ", "UC", "UR", "UT", "UN"}

# Binary numeric VRs: (struct fmt char, size).
BINARY_VR_FMT = {
    "US": ("H", 2),
    "SS": ("h", 2),
    "UL": ("I", 4),
    "SL": ("i", 4),
    "FL": ("f", 4),
    "FD": ("d", 8),
    "AT": ("I", 4),
}

STRING_VRS = {"AE", "AS", "CS", "DA", "DT", "LO", "LT", "PN", "SH", "ST", "TM", "UC", "UI", "UR", "UT"}
NUMERIC_STRING_VRS = {"DS", "IS"}

# Standard transfer syntaxes.
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"
MR_IMAGE_STORAGE = "1.2.840.10008.5.1.4.1.1.4"
ENHANCED_MR_IMAGE_STORAGE = "1.2.840.10008.5.1.4.1.1.4.1"
SECONDARY_CAPTURE_STORAGE = "1.2.840.10008.5.1.4.1.1.7"

# Root used when generating UIDs (public example root).
UID_ROOT = "2.25"
